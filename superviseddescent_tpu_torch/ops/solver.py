"""Regularised least squares through the normal equations.

Counterpart of ``superviseddescent_tpu/ops/solver.py`` (reference:
superviseddescent/regressors.hpp, PartialPivLUSolver and
ColPivHouseholderQRSolver): solves ``(A^T A + diag(reg)) W = A^T B``.

``A^T A`` and ``A^T B`` are plain large matrix products (``torch.matmul``);
the factorisations are PyTorch's (``lu``: ``torch.linalg.solve``, parity
with Eigen's PartialPivLU; ``cholesky``: valid when the regularised matrix
is positive definite; ``qr``: the diagnostic path that estimates the rank
and warns when the matrix is singular).

The normal equations square the condition number, so the products must be
true float32: ``float32_matmul`` switches TF32 off around them and around
the factorisation's solves, whatever the process-wide setting is, and
restores it.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from superviseddescent_tpu_torch.core.regulariser import Regulariser


@contextlib.contextmanager
def float32_matmul():
    """Run the enclosed CUDA matrix products in full float32: TF32 (about
    three decimal digits) is switched off and the caller's setting
    restored afterwards."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@contextlib.contextmanager
def tf32_matmul():
    """Run the enclosed CUDA matrix products on the TF32 tensor cores, and
    restore the caller's setting afterwards. Exact for operands that are
    bfloat16 values held in float32: every such value is a TF32 value, so
    the products are exact and only the float32 sums round (no effect on
    the CPU, whose products stay float32)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def normal_equations(data: torch.Tensor, labels: torch.Tensor):
    """``(A^T A, A^T B)`` of an (N, F) design matrix and (N, L) labels, in
    the tensors' own precision."""
    with float32_matmul():
        at = data.t()
        return torch.matmul(at, data), torch.matmul(at, labels)


def solve_ridge_normal_equations(data: torch.Tensor, labels: torch.Tensor,
                                 regulariser: Regulariser = Regulariser(),
                                 method: str = "lu") -> torch.Tensor:
    """Solve ``(data^T data + diag(reg)) W = data^T labels``.

    data: (N, F), one sample per row. labels: (N, L), each column with its
    own coefficient column. regulariser: MatrixNorm uses ||AtA||_F / N.
    method: ``lu``, ``cholesky`` or ``qr``. Returns the (F, L) weights.
    """
    if data.ndim != 2 or labels.ndim != 2:
        raise ValueError("data and labels must be rank-2 (N,F) and (N,L)")
    ata, atb = normal_equations(data, labels)
    return _solve_from_normal(ata, atb, data.shape[0], regulariser, method)


def _solve_from_normal(ata, atb, num_samples, regulariser, method):
    """Regularise AtA and factorise. The whole solve runs under
    ``float32_matmul``: the triangular solves of the factorisations go
    through cuBLAS with the process's handle, so TF32 must be off for them
    as for the products."""
    with float32_matmul():
        ata_reg = ata + torch.diag(regulariser.diagonal(ata, num_samples))
        if method == "cholesky":
            chol = torch.linalg.cholesky(ata_reg)
            return torch.cholesky_solve(atb, chol)
        if method == "lu":
            return torch.linalg.solve(ata_reg, atb)
        if method == "qr":
            # the reference's ColPivHouseholderQRSolver: estimate the rank,
            # warn when the regularised matrix is singular, solve through
            # the factors
            q, r = torch.linalg.qr(ata_reg)
            rdiag = r.diagonal().abs()
            n = ata_reg.shape[0]
            tol = torch.finfo(ata_reg.dtype).eps * n * rdiag.max()
            rank = int((rdiag > tol).sum())
            if rank < n:
                print(f"The regularised AtA is not invertible (rank {rank}, "
                      f"full rank would be {n}). The solve may return "
                      "garbage. Increase lambda.", file=sys.stderr,
                      flush=True)
            qtb = torch.matmul(q.t(), atb)
            return torch.linalg.solve_triangular(r, qtb, upper=True)
    raise ValueError(f"unknown solve method: {method!r}")
