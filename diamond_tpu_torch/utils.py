"""The parts of diamond_tpu/utils.py the port's train steps and data path use: the
confusion matrix of the rew/end loss (on the device), the per-class precision, recall
and F1 computed from it (on the host), and the pickle I/O of the dataset's state.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

Logs = List[Dict[str, Any]]


# ---------------------------------------------------------------------------
# Files


def save_with_backup(obj: Any, path: Union[str, Path]) -> None:
    """Swap-in save: the old file becomes ``.bk``, the new one is pickled, then the
    ``.bk`` goes (the same files as the JAX package's)."""
    path = Path(path)
    bk = path.with_suffix(".bk")
    if path.is_file():
        path.rename(bk)
    with path.open("wb") as f:
        pickle.dump(obj, f)
    bk.unlink(missing_ok=True)


def load_pickle(path: Union[str, Path]) -> Any:
    with Path(path).open("rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# Metrics


def multiclass_confusion_matrix(logits: torch.Tensor, targets: torch.Tensor,
                                num_classes: int,
                                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_classes, num_classes) f32 confusion matrix, rows the true classes, columns the
    predicted ones (argmax of ``logits``, the first maximum), each sample counted with its
    weight (the padding mask), on the device of the inputs."""
    preds = logits.argmax(dim=-1)
    onehot_t = torch.nn.functional.one_hot(targets.long(), num_classes).float()
    onehot_p = torch.nn.functional.one_hot(preds, num_classes).float()
    if weights is not None:
        onehot_t = onehot_t * weights[..., None].float()
    return torch.einsum("...i,...j->ij", onehot_t, onehot_p)


def compute_classification_metrics(cm: np.ndarray
                                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class precision, recall and F1 of a confusion matrix (rows true, columns
    predicted); 0 where a ratio has no denominator."""
    cm = np.asarray(cm, dtype=np.float64)
    n = cm.shape[0]
    precision, recall, f1 = np.zeros(n), np.zeros(n), np.zeros(n)
    for i in range(n):
        tp = cm[i, i]
        fp = cm[:, i].sum() - tp
        fn = cm[i, :].sum() - tp
        precision[i] = tp / (tp + fp) if (tp + fp) else 0.0
        recall[i] = tp / (tp + fn) if (tp + fn) else 0.0
        s = precision[i] + recall[i]
        f1[i] = 2 * precision[i] * recall[i] / s if s else 0.0
    return precision, recall, f1


def process_confusion_matrices_if_any_and_compute_classification_metrics(logs: Logs) -> None:
    """Pop the ``confusion_matrix`` entries of the logged steps, sum them per key and
    append one dict of per-class precision, recall and F1 to ``logs``."""
    cms = [x.pop("confusion_matrix") for x in logs if "confusion_matrix" in x]
    if not cms:
        return
    accum = {k: sum(_to_numpy(d[k]) for d in cms) for k in cms[0]}
    metrics: Dict[str, float] = {}
    for key, cm in accum.items():
        precision, recall, f1 = compute_classification_metrics(cm)
        for i in range(len(precision)):
            metrics[f"classification_metrics/{key}_precision_class_{i}"] = float(precision[i])
            metrics[f"classification_metrics/{key}_recall_class_{i}"] = float(recall[i])
            metrics[f"classification_metrics/{key}_f1_score_class_{i}"] = float(f1[i])
    logs.append(metrics)


def _to_numpy(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
