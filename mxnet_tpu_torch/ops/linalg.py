"""Linear-algebra ops (counterpart of `mxnet_tpu/ops/linalg.py`; reference:
src/operator/tensor/la_op.cc): gemm, gemm2, potrf, potri, trsm, trmm,
sumlogdiag, syrk, gelqf, syevd, makediag, extractdiag, inverse, det and
slogdet, batched over the leading axes, with the JAX package's output
order and conventions: ``gelqf`` returns (L, Q) with A = L Q, ``syevd``
(V^T, w) with w ascending, ``slogdet`` (sign, log|det|). PyTorch's
decompositions (LAPACK on the host, cuSOLVER / MAGMA on the card) are the
counterparts of XLA's; a factor's column signs are the library's.
"""
from __future__ import annotations

import torch

from . import register


def _t(x, transpose):
    return x.transpose(-1, -2) if transpose else x


@register("_linalg_gemm", aliases=("linalg_gemm",))
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
        + beta * C


@register("_linalg_gemm2", aliases=("linalg_gemm2",))
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))


@register("_linalg_potrf", aliases=("linalg_potrf",))
def linalg_potrf(A):
    """The lower Cholesky factor L of A = L L^T."""
    return torch.linalg.cholesky(A)


@register("_linalg_potri", aliases=("linalg_potri",))
def linalg_potri(A):
    """A^-1 from A's lower Cholesky factor (the input): (L^-1)^T L^-1."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    inv_l = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(inv_l.transpose(-1, -2), inv_l)


@register("_linalg_trsm", aliases=("linalg_trsm",))
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """X with op(A) X = alpha B, or X op(A) = alpha B with ``rightside``;
    A triangular (``lower``), op the transpose with ``transpose``."""
    M = _t(A, transpose)
    upper = lower == transpose   # transposing flips the triangle
    return torch.linalg.solve_triangular(M, alpha * B, upper=upper,
                                         left=not rightside)


@register("_linalg_trmm", aliases=("linalg_trmm",))
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    At = _t(A, transpose)
    return alpha * (torch.matmul(B, At) if rightside else torch.matmul(At, B))


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("_linalg_syrk", aliases=("linalg_syrk",))
def linalg_syrk(A, transpose=False, alpha=1.0):
    At = A.transpose(-1, -2)
    return alpha * (torch.matmul(At, A) if transpose else torch.matmul(A, At))


@register("_linalg_gelqf", aliases=("linalg_gelqf",), num_outputs=2)
def linalg_gelqf(A):
    """(L, Q): A (m, n), m <= n, as L (m, m) lower times Q (m, n) with
    orthonormal rows, from the reduced QR of A^T."""
    q, r = torch.linalg.qr(A.transpose(-1, -2), mode="reduced")
    return r.transpose(-1, -2), q.transpose(-1, -2)


@register("_linalg_syevd", aliases=("linalg_syevd",), num_outputs=2)
def linalg_syevd(A):
    """(V^T, w): eigenvectors of the symmetric A as rows, eigenvalues
    ascending."""
    w, v = torch.linalg.eigh(A)
    return v.transpose(-1, -2), w


@register("_linalg_makediag", aliases=("linalg_makediag",))
def linalg_makediag(A, offset=0):
    """(..., n) -> (..., n, n) with A on the diagonal (``offset`` is
    accepted and, as in the JAX package, not applied)."""
    return torch.diag_embed(A)


@register("_linalg_extractdiag", aliases=("linalg_extractdiag",))
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register("_linalg_inverse", aliases=("linalg_inverse",))
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("_linalg_det", aliases=("linalg_det",))
def linalg_det(A):
    return torch.linalg.det(A)


@register("_linalg_slogdet", aliases=("linalg_slogdet",), num_outputs=2)
def linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet
