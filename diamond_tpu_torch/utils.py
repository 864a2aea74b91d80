"""Utilities (diamond_tpu/utils.py): the JSONL metrics sink (wandb on top where its
mode asks for it), the rotation of the weights-only agent snapshots, the confusion
matrix of the rew/end loss (on the device) and the per-class precision, recall and F1
computed from it (on the host), the final-evaluation protocol's numbers, the pickle I/O
of the dataset's state, seeding, the finished-run guard and a timer.
"""

from __future__ import annotations

import json
import pickle
import random
import time
from functools import partial
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

Logs = List[Dict[str, Any]]


# ---------------------------------------------------------------------------
# Logging


class MetricsLogger:
    """Append-only JSONL metrics file; wandb (imported only where ``wandb_cfg["mode"]``
    is not ``disabled``) gets the same rows. wandb's init is tried three times; after
    that the run logs to the file only and says so."""

    WANDB_INIT_RETRIES = 3

    def __init__(self, path: Union[str, Path], wandb_cfg: Optional[Dict[str, Any]] = None
                 ) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._wandb = None
        if wandb_cfg and wandb_cfg.get("mode", "disabled") != "disabled":
            for attempt in range(self.WANDB_INIT_RETRIES):
                try:
                    import wandb  # type: ignore

                    wandb.init(**{k: v for k, v in wandb_cfg.items() if k != "mode"},
                               resume=True)
                    self._wandb = wandb
                    break
                except Exception as e:
                    if attempt == self.WANDB_INIT_RETRIES - 1:
                        print(f"wandb disabled after {self.WANDB_INIT_RETRIES} failed init "
                              f"attempts ({e!r}); logging to JSONL only")
                    else:
                        time.sleep(5.0 * (attempt + 1))

    def log(self, logs: Logs, epoch: int) -> None:
        with self.path.open("a") as f:
            for d in logs:
                row = {"epoch": epoch, **{k: _to_py(v) for k, v in d.items()}}
                f.write(json.dumps(row) + "\n")
                if self._wandb is not None:
                    self._wandb.log(row)


def _to_py(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.tolist() if v.ndim > 0 else float(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def final_protocol_metrics(to_log: Logs, episodes: int) -> Dict[str, Any]:
    """The final evaluation's numbers: the mean and std of the returns of the first
    ``episodes`` episodes in completion order (batched test envs may finish more in the
    last step), and the mean over all collected as a secondary metric. With no episode
    the means are NaN (numpy's mean of nothing)."""
    returns = [d["return"] for d in to_log if "return" in d]
    protocol = returns[:episodes]
    return {"final_return_mean": float(np.mean(protocol)),
            "final_return_std": float(np.std(protocol)),
            "final_num_episodes": len(protocol),
            "final_return_mean_all_collected": float(np.mean(returns)),
            "final_num_episodes_all_collected": len(returns)}


# ---------------------------------------------------------------------------
# Agent snapshots


def get_path_agent_ckpt(path_ckpt_dir: Union[str, Path], epoch: int, num_zeros: int = 5
                        ) -> Path:
    """The snapshot of ``epoch``; a negative epoch counts from the newest kept one."""
    d = Path(path_ckpt_dir) / "agent_versions"
    if epoch >= 0:
        return d / f"agent_epoch_{epoch:0{num_zeros}d}.npz"
    all_ = sorted(p for p in d.iterdir() if p.suffix == ".npz")
    assert len(all_) >= -epoch
    return all_[epoch]


def keep_agent_copies_every(agent_sd: Dict[str, Any], epoch: int, path_ckpt_dir: Path,
                            every: int, num_to_keep: Optional[int]) -> None:
    """Write this epoch's snapshot; keep one every ``every`` epochs, at most
    ``num_to_keep`` of them, and the latest."""
    assert every > 0
    assert num_to_keep is None or num_to_keep > 0
    from .checkpoint import save_agent_snapshot

    get_path = partial(get_path_agent_ckpt, path_ckpt_dir)
    get_path(0).parent.mkdir(parents=True, exist_ok=True)
    save_agent_snapshot(agent_sd, get_path(epoch))
    if (num_to_keep is not None) and (epoch % every == 0):
        get_path(max(0, epoch - num_to_keep * every)).unlink(missing_ok=True)
    if (epoch - 1) % every != 0:
        get_path(max(0, epoch - 1)).unlink(missing_ok=True)


def save_info_for_import_script(epoch: int, run_name: Optional[str], path_ckpt_dir: Path
                                ) -> None:
    with (Path(path_ckpt_dir) / "info_for_import_script.json").open("w") as f:
        json.dump({"epoch": epoch, "name": run_name}, f)


def count_parameters(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


# ---------------------------------------------------------------------------
# Runs


def set_seed(seed: int) -> None:
    """numpy's and Python's global generators (the port's own draws take generators)."""
    np.random.seed(seed)
    random.seed(seed)


def skip_if_run_is_over(func: Callable) -> Callable:
    """Run ``func`` unless the run dir (the working directory) holds ``.run_is_over``;
    mark it so after a run that returned."""

    def inner(*args, **kwargs):
        path_run_is_over = Path(".run_is_over")
        if not path_run_is_over.is_file():
            func(*args, **kwargs)
            path_run_is_over.touch()
        else:
            print(f"Run is marked as finished. To unmark, remove '{path_run_is_over}'.")

    return inner


def try_until_no_except(func: Callable) -> None:
    while True:
        try:
            func()
        except KeyboardInterrupt:
            break
        except Exception:
            continue
        else:
            break


class Timer:
    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = time.perf_counter() - self.start


# ---------------------------------------------------------------------------
# Host to device


def to_device(x: Any, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on the card from pinned memory, without waiting for
    the copy; a plain copy elsewhere. A tensor is moved as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


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
