"""Config singleton: env vars + optional INI file
(reference: python/lynse/configs/config.py:9,138-225 — LYNSE_* env vars
merged with ~/.lynsedb_configs.ini)."""

from __future__ import annotations

import configparser
import os
from pathlib import Path

CONFIG_FILE = Path(os.environ.get("LYNSE_CONFIG_FILE", Path.home() / ".lynsedb_tpu_configs.ini"))

_DEFAULTS = {
    "LYNSE_LOG_LEVEL": "INFO",
    "LYNSE_LOG_PATH": "",
    "LYNSE_TRUNCATE_LOG": "true",
    "LYNSE_LOG_WITH_TIME": "true",
    "LYNSE_KMEANS_EPOCHS": "100",
    "LYNSE_SEARCH_CACHE_SIZE": "1000",
    "LYNSE_SEARCH_CACHE_EXPIRE_SECONDS": "3600",
    "LYNSE_DEFAULT_ROOT_PATH": str(Path.home() / ".lynsedb_tpu" / "data"),
}


def generate_config_file() -> None:
    if CONFIG_FILE.exists():
        return
    cp = configparser.ConfigParser()
    cp["lynse"] = _DEFAULTS
    try:
        CONFIG_FILE.parent.mkdir(parents=True, exist_ok=True)
        with open(CONFIG_FILE, "w") as fh:
            cp.write(fh)
    except OSError:
        pass


def load_config_file() -> dict:
    merged = dict(_DEFAULTS)
    if CONFIG_FILE.exists():
        cp = configparser.ConfigParser()
        try:
            cp.read(CONFIG_FILE)
            if "lynse" in cp:
                merged.update({k.upper(): v for k, v in cp["lynse"].items()})
        except configparser.Error:
            pass
    for key in list(merged):
        if key in os.environ:
            merged[key] = os.environ[key]
    return merged


class Config:
    def __init__(self):
        for key, value in load_config_file().items():
            setattr(self, key, value)
        self.LYNSE_KMEANS_EPOCHS = int(self.LYNSE_KMEANS_EPOCHS)
        self.LYNSE_SEARCH_CACHE_SIZE = int(self.LYNSE_SEARCH_CACHE_SIZE)
        self.LYNSE_SEARCH_CACHE_EXPIRE_SECONDS = int(self.LYNSE_SEARCH_CACHE_EXPIRE_SECONDS)


config = Config()
