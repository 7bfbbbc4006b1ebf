"""Device compute core: distance transforms, top-k selection and the flat
scan, each hand-written CUDA kernel beside its plain PyTorch version."""
