"""Evaluation metrics for deconvolution outputs.

The port's own copy of :mod:`flashdeconv_tpu.utils.metrics`, unchanged.

Host-side numpy: metrics run once on small (N x K) proportion matrices.
Parity targets: reference ``flashdeconv/utils/metrics.py`` (RMSE :12-39,
MAE :42-69, correlations :72-119, JSD :122-162, report :165-219, rare-type
detection :222-266).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def compute_rmse(
    pred: np.ndarray, true: np.ndarray, per_cell_type: bool = False
) -> np.ndarray:
    """Root-mean-square error, overall or per cell type (columns)."""
    sq = (pred - true) ** 2
    return np.sqrt(sq.mean(axis=0)) if per_cell_type else np.sqrt(sq.mean())


def compute_mae(
    pred: np.ndarray, true: np.ndarray, per_cell_type: bool = False
) -> np.ndarray:
    """Mean absolute error, overall or per cell type."""
    ae = np.abs(pred - true)
    return ae.mean(axis=0) if per_cell_type else ae.mean()


def _corr_1d(x: np.ndarray, y: np.ndarray, method: str) -> float:
    """Correlation of two vectors; 0.0 when either input is constant."""
    if np.ptp(x) == 0 or np.ptp(y) == 0:
        return 0.0
    if method == "spearman":
        from scipy.stats import spearmanr

        return float(spearmanr(x, y)[0])
    return float(np.corrcoef(x, y)[0, 1])


def compute_correlation(
    pred: np.ndarray,
    true: np.ndarray,
    method: str = "pearson",
    per_cell_type: bool = False,
) -> np.ndarray:
    """Pearson or Spearman correlation (flattened, or per cell type column)."""
    if per_cell_type:
        return np.array(
            [_corr_1d(pred[:, k], true[:, k], method) for k in range(pred.shape[1])]
        )
    return _corr_1d(pred.ravel(), true.ravel(), method)


def compute_jsd(
    pred: np.ndarray, true: np.ndarray, epsilon: float = 1e-10
) -> np.ndarray:
    """Per-spot Jensen-Shannon divergence between proportion vectors."""
    p = np.clip(pred, epsilon, 1 - epsilon)
    q = np.clip(true, epsilon, 1 - epsilon)
    p = p / p.sum(axis=1, keepdims=True)
    q = q / q.sum(axis=1, keepdims=True)
    m = 0.5 * (p + q)
    kl_p = np.sum(p * np.log(p / m), axis=1)
    kl_q = np.sum(q * np.log(q / m), axis=1)
    return 0.5 * (kl_p + kl_q)


def evaluate_deconvolution(
    pred: np.ndarray,
    true: np.ndarray,
    cell_type_names: Optional[np.ndarray] = None,
) -> dict:
    """Aggregate accuracy report: overall + per-cell-type metric dictionary."""
    n_types = pred.shape[1]
    if cell_type_names is None:
        cell_type_names = [f"CellType_{i}" for i in range(n_types)]

    report = {
        "overall": {
            "rmse": float(compute_rmse(pred, true)),
            "mae": float(compute_mae(pred, true)),
            "pearson": float(compute_correlation(pred, true, "pearson")),
            "spearman": float(compute_correlation(pred, true, "spearman")),
            "mean_jsd": float(np.mean(compute_jsd(pred, true))),
        },
        "per_cell_type": {},
    }

    rmse_k = compute_rmse(pred, true, per_cell_type=True)
    mae_k = compute_mae(pred, true, per_cell_type=True)
    pear_k = compute_correlation(pred, true, "pearson", per_cell_type=True)
    spear_k = compute_correlation(pred, true, "spearman", per_cell_type=True)
    for k, name in enumerate(cell_type_names):
        report["per_cell_type"][str(name)] = {
            "rmse": float(rmse_k[k]),
            "mae": float(mae_k[k]),
            "pearson": float(pear_k[k]),
            "spearman": float(spear_k[k]),
            "mean_proportion_true": float(true[:, k].mean()),
            "mean_proportion_pred": float(pred[:, k].mean()),
        }
    return report


def compute_rare_cell_detection(
    pred: np.ndarray,
    true: np.ndarray,
    threshold: float = 0.05,
) -> Tuple[float, float, float]:
    """Precision/recall/F1 for detecting rare (0 < true < threshold) entries.

    Predictions count as "present" above ``threshold / 2`` (lenient); false
    positives are predicted-present entries where the truth is exactly zero.
    Returns (nan, nan, nan) when no rare entries exist.
    """
    rare = (true > 0) & (true < threshold)
    if not np.any(rare):
        return np.nan, np.nan, np.nan

    present = pred > (threshold / 2)
    tp = np.sum(present & rare)
    fp = np.sum(present & ~rare & (true == 0))
    fn = np.sum(~present & rare)

    precision = tp / (tp + fp + 1e-10)
    recall = tp / (tp + fn + 1e-10)
    f1 = 2 * precision * recall / (precision + recall + 1e-10)
    return precision, recall, f1
