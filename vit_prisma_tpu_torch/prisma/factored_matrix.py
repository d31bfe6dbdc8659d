"""FactoredMatrix: a lazy low-rank product A·B for circuit analysis
(PyTorch port of ``vit_prisma_tpu/prisma/factored_matrix.py``).

The SVD comes from the factors' SVDs and a small middle SVD, the
eigenvalues from the square product BA; ``@`` and ``*`` keep the product
factored where that is cheaper, and indexing works on the leading dims.
Everything is batched over any leading dims (``[n_layers, n_heads, ...]``
head circuits in one call) and runs on the factors' device.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-2, -1)


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=like.device)


class FactoredMatrix:
    def __init__(self, A, B):
        A = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
        B = _as_tensor(B, A)
        assert A.shape[-1] == B.shape[-2], (
            f"Factored matrix must match on inner dimension, shapes were "
            f"a: {tuple(A.shape)}, b: {tuple(B.shape)}")
        self.ldim = A.shape[-2]
        self.rdim = B.shape[-1]
        self.mdim = B.shape[-2]
        self.has_leading_dims = (A.ndim > 2) or (B.ndim > 2)
        lead = tuple(np.broadcast_shapes(tuple(A.shape[:-2]), tuple(B.shape[:-2])))
        self.shape = lead + (self.ldim, self.rdim)
        self.A = A.broadcast_to(lead + (self.ldim, self.mdim))
        self.B = B.broadcast_to(lead + (self.mdim, self.rdim))
        self._svd_cache = None

    # -- products --------------------------------------------------------
    def __matmul__(self, other):
        if isinstance(other, FactoredMatrix):
            return (self @ other.A) @ other.B
        other = _as_tensor(other, self.A)
        if other.ndim < 2:
            return (self.A @ (self.B @ other[..., None]))[..., 0]
        assert other.shape[-2] == self.rdim
        if self.rdim > self.mdim:
            return FactoredMatrix(self.A, self.B @ other)
        return FactoredMatrix(self.AB, other)

    def __rmatmul__(self, other):
        if isinstance(other, FactoredMatrix):
            return other.A @ (other.B @ self)
        other = _as_tensor(other, self.A)
        assert other.shape[-1] == self.ldim
        if other.ndim < 2:
            return ((other[..., None, :] @ self.A) @ self.B)[..., 0, :]
        if self.ldim > self.mdim:
            return FactoredMatrix(other @ self.A, self.B)
        return FactoredMatrix(other, self.AB)

    def __mul__(self, scalar):
        if isinstance(scalar, torch.Tensor):
            assert scalar.numel() == 1, (
                f"Tensor must be a scalar for use with * but was of shape "
                f"{tuple(scalar.shape)}")
        elif hasattr(scalar, "size"):
            assert np.size(scalar) == 1, (
                f"Tensor must be a scalar for use with * but was of shape "
                f"{np.shape(scalar)}")
        return FactoredMatrix(self.A * scalar, self.B)

    def __rmul__(self, scalar):
        return self * scalar

    # -- materialization -------------------------------------------------
    @property
    def AB(self) -> torch.Tensor:
        return self.A @ self.B

    @property
    def BA(self) -> torch.Tensor:
        assert self.rdim == self.ldim, "Can only take BA if ldim==rdim"
        return self.B @ self.A

    @property
    def T(self) -> "FactoredMatrix":
        return FactoredMatrix(_T(self.B), _T(self.A))

    # -- SVD -------------------------------------------------------------
    def svd(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(U, S, Vh) with U [... ldim mdim], S [... mdim], Vh [... rdim
        mdim] such that U @ diag(S) @ Vh^T == AB.  Vh is V, not its
        transpose (the convention of the JAX package and its reference).
        The singular vectors' signs are the solver's."""
        if self._svd_cache is not None:
            return self._svd_cache
        Ua, Sa, Vha = torch.linalg.svd(self.A, full_matrices=False)
        Ub, Sb, Vhb = torch.linalg.svd(self.B, full_matrices=False)
        middle = (Sa[..., :, None] * Vha) @ (Ub * Sb[..., None, :])
        Um, Sm, Vhm = torch.linalg.svd(middle, full_matrices=False)
        U = Ua @ Um
        Vh = _T(Vhb) @ _T(Vhm)
        self._svd_cache = (U, Sm, Vh)
        return self._svd_cache

    @property
    def U(self) -> torch.Tensor:
        return self.svd()[0]

    @property
    def S(self) -> torch.Tensor:
        return self.svd()[1]

    @property
    def Vh(self) -> torch.Tensor:
        return self.svd()[2]

    @property
    def eigenvalues(self) -> torch.Tensor:
        """Eigenvalues of AB == eigenvalues of BA (up to trailing zeros)."""
        return torch.linalg.eigvals(self.BA)

    # -- norms / reshaping ----------------------------------------------
    def norm(self) -> torch.Tensor:
        """Frobenius norm from the singular values."""
        return torch.sqrt(torch.sum(self.S ** 2, dim=-1))

    def make_even(self) -> "FactoredMatrix":
        s_sqrt = torch.sqrt(self.S)
        return FactoredMatrix(self.U * s_sqrt[..., None, :],
                              s_sqrt[..., :, None] * _T(self.Vh))

    def collapse_l(self) -> torch.Tensor:
        return self.S[..., :, None] * _T(self.Vh)

    def collapse_r(self) -> torch.Tensor:
        return self.U * self.S[..., None, :]

    def unsqueeze(self, k: int) -> "FactoredMatrix":
        return FactoredMatrix(self.A.unsqueeze(k), self.B.unsqueeze(k))

    def get_corner(self, k: int = 3) -> torch.Tensor:
        return self.A[..., :k, :] @ self.B[..., :, :k]

    # -- indexing (leading dims only) ------------------------------------
    def _convert_to_slice(self, sequence: Union[Tuple, List], idx: int) -> Tuple:
        if isinstance(idx, int):
            sequence = list(sequence)
            if isinstance(sequence[idx], int):
                sequence[idx] = slice(sequence[idx], sequence[idx] + 1)
            sequence = tuple(sequence)
        return sequence

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        length = len([i for i in idx if i is not None])
        if length <= len(self.shape) - 2:
            return FactoredMatrix(self.A[idx], self.B[idx])
        elif length == len(self.shape) - 1:
            idx = self._convert_to_slice(idx, -1)
            return FactoredMatrix(self.A[idx], self.B[idx[:-1]])
        elif length == len(self.shape):
            idx = self._convert_to_slice(idx, -1)
            idx = self._convert_to_slice(idx, -2)
            return FactoredMatrix(self.A[idx[:-1]],
                                  self.B[idx[:-2] + (slice(None), idx[-1])])
        raise ValueError(
            f"{idx} is too long an index for a FactoredMatrix with shape {self.shape}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def pair(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.A, self.B)

    def __repr__(self):
        return f"FactoredMatrix: Shape({self.shape}), Hidden Dim({self.mdim})"
