"""Batched small SPD solve (port of steppingstone_tpu/ops/linalg.py).

Right-looking (outer-product) Cholesky over the static matrix size, then
forward and backward substitution. The CUDA control-step kernel runs the
same algorithm per env (csrc/control_step.cu), so the two agree in their
order of operations. fp32; callers add diagonal regularization.
"""

from __future__ import annotations

import torch


def _chol_columns(A: torch.Tensor) -> list:
    """Columns of the lower Cholesky factor of symmetric A (..., n, n);
    column j is zero above the diagonal. The diagonal scale is
    rsqrt(max(d, 1e-12)), so a non-positive pivot cannot produce NaN."""
    n = A.shape[-1]
    below = torch.arange(n, device=A.device)
    cols = []
    for j in range(n):
        d = torch.rsqrt(torch.clamp(A[..., j, j], min=1e-12))
        col = A[..., j, :] * d[..., None] * (below >= j)
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return cols


def cholesky_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of symmetric positive-definite A (..., n, n)."""
    return torch.stack(_chol_columns(A), dim=-1)


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A (..., n, n), b (..., n)."""
    n = A.shape[-1]
    cols = _chol_columns(A)
    diag = [cols[j][..., j] for j in range(n)]

    # forward substitution L y = b; acc[.., i] = sum_{k<j} L[i, k] y_k
    acc = torch.zeros_like(b)
    y = []
    for j in range(n):
        yj = (b[..., j] - acc[..., j]) / diag[j]
        y.append(yj)
        acc = acc + cols[j] * yj[..., None]

    # backward substitution L^T x = y: x_j = (y_j - sum_{k>j} L[k, j] x_k) / L[j, j]
    x = torch.zeros_like(b)
    for j in reversed(range(n)):
        s = torch.sum(cols[j] * x, dim=-1)
        x[..., j] = (y[j] - s) / diag[j]
    return x
