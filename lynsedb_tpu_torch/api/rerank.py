"""External rerank hook (reference: python/lynse/api/rerank.py:19).

The reranker callable receives ``{"query": ..., "items": [{"id", "score",
"field"}, ...]}`` and may return: None (keep order), a list of ids, a dict
with "ids"/"scores", a score array aligned with the input, or a list of
(id, score) pairs. Unknown ids are dropped; missing ids are back-filled in
original order; rerank_k truncates.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


def should_fetch_fields(*, return_fields: bool, reranker, rerank_with_fields: bool) -> bool:
    return return_fields or (reranker is not None and rerank_with_fields)


def _normalize_output(output, ids: list, scores: np.ndarray):
    """-> (ranked_ids, ranked_scores | None)"""
    if output is None:
        return list(ids), None
    if isinstance(output, dict):
        out_ids = output.get("ids")
        out_scores = output.get("scores")
        if out_ids is None and out_scores is not None:
            arr = np.asarray(out_scores, dtype=np.float64)
            if len(arr) != len(ids):
                raise ValueError("rerank scores length must match items length")
            order = np.argsort(-arr, kind="stable")
            return [ids[i] for i in order], arr[order]
        if out_ids is None:
            raise ValueError("rerank dict must contain 'ids' and/or 'scores'")
        out_ids = list(out_ids)
        if out_scores is not None:
            arr = np.asarray(out_scores, dtype=np.float64)
            if len(arr) != len(out_ids):
                raise ValueError("rerank ids and scores must have the same length")
            return out_ids, arr
        return out_ids, None
    if isinstance(output, np.ndarray):
        arr = output.astype(np.float64)
        if len(arr) != len(ids):
            raise ValueError("rerank score array length must match items length")
        order = np.argsort(-arr, kind="stable")
        return [ids[i] for i in order], arr[order]
    if isinstance(output, tuple) and len(output) == 2:
        out_ids, out_scores = output
        return list(out_ids), np.asarray(out_scores, dtype=np.float64)
    if isinstance(output, (list,)):
        if output and isinstance(output[0], (tuple, list)) and len(output[0]) == 2:
            out_ids = [p[0] for p in output]
            out_scores = np.asarray([p[1] for p in output], dtype=np.float64)
            return out_ids, out_scores
        return list(output), None
    raise TypeError(f"unsupported reranker output type: {type(output).__name__}")


def apply_external_rerank(
    *,
    ids: np.ndarray,
    scores: np.ndarray,
    fields: List[Dict[str, Any]],
    reranker: Optional[Callable[[Dict[str, Any]], Any]],
    query: Dict[str, Any],
    rerank_k: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, List[Dict[str, Any]]]:
    ids = np.asarray(ids)
    scores = np.asarray(scores, dtype=np.float32)
    total = len(ids)
    target_k = total if rerank_k is None else max(0, min(int(rerank_k), total))
    if target_k == 0:
        return ids[:0], np.array([], dtype=np.float32), []
    if reranker is None:
        return ids[:target_k], scores[:target_k], fields[:target_k] if fields else []
    if not callable(reranker):
        raise TypeError("reranker must be callable")

    id_list = ids.tolist()
    items = [
        {"id": i, "score": float(s), "field": fields[pos] if pos < len(fields) else None}
        for pos, (i, s) in enumerate(zip(id_list, scores))
    ]
    ranked_ids, ranked_scores = _normalize_output(
        reranker({"query": query, "items": items}), id_list, scores
    )

    pos_of = {i: p for p, i in enumerate(id_list)}
    used = set()
    out_ids, out_scores, out_fields = [], [], []

    def _take(item_id, score):
        used.add(item_id)
        out_ids.append(item_id)
        out_scores.append(score)
        if fields:
            p = pos_of[item_id]
            out_fields.append(fields[p] if p < len(fields) else {})

    for rank, item_id in enumerate(ranked_ids):
        if item_id in used or item_id not in pos_of:
            continue
        score = (
            float(ranked_scores[rank]) if ranked_scores is not None else float(scores[pos_of[item_id]])
        )
        _take(item_id, score)
        if len(out_ids) >= target_k:
            break
    if len(out_ids) < target_k:
        for item_id in id_list:
            if item_id not in used:
                _take(item_id, float(scores[pos_of[item_id]]))
                if len(out_ids) >= target_k:
                    break

    return (
        np.array(out_ids, dtype=ids.dtype),
        np.array(out_scores, dtype=np.float32),
        out_fields if fields else [],
    )
