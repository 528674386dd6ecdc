"""Pallas (Triton) kernel: the batched Riccati backward pass.

One program owns a block of ``blk`` scenarios, one scenario per thread, and
walks the whole horizon backward in a ``fori_loop`` over knots. The
dynamics (A, B) are SHARED by the batch and read as scalars; the AL
expansion (lx, lu, lxx, luu, lux), computed by XLA, is per lane. Each
lane's matrices (the value Hessian and the Q-function blocks) live in a
per-lane scratch region of device memory that only its own thread touches.

The knot body is written as short loops over matrix rows or columns
rather than fully unrolled, so each loop body holds O(n^2) operations and
not O(n^3): the Triton compile time follows the largest straight-line
block, and a fully unrolled n=12 knot (~10^4 operations) did not finish
compiling within 13 minutes.

Against the XLA path (a vmapped ``lax.scan`` whose every knot is a chain of
small batched matmuls, a Cholesky and two triangular solves) this is one
launch per backward pass.

Recursion and outputs match ``solver.altro.backward_pass``, except that the
value Hessian is not re-symmetrised each knot (the update is symmetric in
exact arithmetic; f32 rounding leaves an asymmetry at the 1e-7 relative
level).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from .dispatch import (compiler_params, fori, lanes_first, lanes_last,
                       padded_batch)

# Scenarios per program (= 32 x num_warps threads).
BLOCK = 32


def _make_kernel(n, m, N1, blk):
    def kernel(A_ref, B_ref, lx_ref, lu_ref, lxx_ref, luu_ref, lux_ref,
               reg_ref, K_ref, d_ref, dV_ref,
               V_ref, Vx_ref, VA_ref, VB_ref, Qxx_ref, Qux_ref, Quu_ref,
               QuuK_ref, Qx_ref):
        lanes = pl.ds(pl.program_id(0) * blk, blk)

        def init(i):
            Vx_ref[i, lanes] = lx_ref[N1, i, lanes]
            for j in range(n):
                V_ref[i, j, lanes] = lxx_ref[N1, i, j, lanes]

        fori(n, init)
        reg = reg_ref[lanes]

        def knot(t, dV):
            k = N1 - 1 - t

            def rows(i):                       # VA = V A, VB = V B
                v = [V_ref[i, p, lanes] for p in range(n)]
                for j in range(n):
                    VA_ref[i, j, lanes] = sum(v[p] * A_ref[k, p, j]
                                              for p in range(n))
                for j in range(m):
                    VB_ref[i, j, lanes] = sum(v[p] * B_ref[k, p, j]
                                              for p in range(n))

            fori(n, rows)
            vx = [Vx_ref[p, lanes] for p in range(n)]

            def cols(j):                       # Qxx, Qux, Qx: column j
                va = [VA_ref[p, j, lanes] for p in range(n)]
                for i in range(n):
                    Qxx_ref[i, j, lanes] = lxx_ref[k, i, j, lanes] + sum(
                        A_ref[k, p, i] * va[p] for p in range(n))
                for i in range(m):
                    Qux_ref[i, j, lanes] = lux_ref[k, i, j, lanes] + sum(
                        B_ref[k, p, i] * va[p] for p in range(n))
                Qx_ref[j, lanes] = lx_ref[k, j, lanes] + sum(
                    A_ref[k, p, j] * vx[p] for p in range(n))

            fori(n, cols)

            def ucols(j):                      # Quu: column j
                vb = [VB_ref[p, j, lanes] for p in range(n)]
                for i in range(m):
                    Quu_ref[i, j, lanes] = luu_ref[k, i, j, lanes] + sum(
                        B_ref[k, p, i] * vb[p] for p in range(n))

            fori(m, ucols)
            Quu = [[Quu_ref[i, j, lanes] for j in range(m)]
                   for i in range(m)]
            Qu = [lu_ref[k, i, lanes] + sum(B_ref[k, p, i] * vx[p]
                                            for p in range(n))
                  for i in range(m)]

            # lane-wise Cholesky of Quu + reg I
            L = [[None] * m for _ in range(m)]
            for j in range(m):
                dgj = Quu[j][j] + reg
                for p in range(j):
                    dgj = dgj - L[j][p] * L[j][p]
                L[j][j] = jnp.sqrt(jnp.maximum(dgj, 1e-12))
                for i in range(j + 1, m):
                    s = Quu[i][j]
                    for p in range(j):
                        s = s - L[i][p] * L[j][p]
                    L[i][j] = s / L[j][j]

            def chol_solve(b):
                y = [None] * m
                for i in range(m):
                    s = b[i]
                    for p in range(i):
                        s = s - L[i][p] * y[p]
                    y[i] = s / L[i][i]
                z = [None] * m
                for i in range(m - 1, -1, -1):
                    s = y[i]
                    for p in range(i + 1, m):
                        s = s - L[p][i] * z[p]
                    z[i] = s / L[i][i]
                return z

            dk = chol_solve([-q for q in Qu])
            for i in range(m):
                d_ref[k, i, lanes] = dk[i]

            def kcols(j):                      # K = -(Quu+reg)^-1 Qux
                kc = chol_solve([-Qux_ref[i, j, lanes] for i in range(m)])
                for i in range(m):
                    K_ref[k, i, j, lanes] = kc[i]
                    QuuK_ref[i, j, lanes] = sum(Quu[i][q] * kc[q]
                                                for q in range(m))

            fori(n, kcols)
            Quud = [sum(Quu[i][p] * dk[p] for p in range(m))
                    for i in range(m)]
            w = [Quud[p] + Qu[p] for p in range(m)]

            def vx_rows(i):                    # Vx' = Qx + K'(Quu d + Qu) + Qux'd
                Vx_ref[i, lanes] = Qx_ref[i, lanes] + sum(
                    K_ref[k, p, i, lanes] * w[p]
                    + Qux_ref[p, i, lanes] * dk[p] for p in range(m))

            fori(n, vx_rows)

            def v_cols(j):                     # V' = Qxx + K'QuuK + K'Qux + Qux'K
                kj = [K_ref[k, p, j, lanes] for p in range(m)]
                c = [QuuK_ref[p, j, lanes] + Qux_ref[p, j, lanes]
                     for p in range(m)]
                for i in range(n):
                    V_ref[i, j, lanes] = Qxx_ref[i, j, lanes] + sum(
                        K_ref[k, p, i, lanes] * c[p]
                        + Qux_ref[p, i, lanes] * kj[p] for p in range(m))

            fori(n, v_cols)
            dV1, dV2 = dV
            return (dV1 + sum(dk[i] * Qu[i] for i in range(m)),
                    dV2 + 0.5 * sum(dk[i] * Quud[i] for i in range(m)))

        zero = jnp.zeros_like(reg)
        dV1, dV2 = jax.lax.fori_loop(np.int32(0), np.int32(N1), knot,
                                     (zero, zero))
        dV_ref[0, lanes] = dV1
        dV_ref[1, lanes] = dV2

    return kernel


def batched_backward(A, B, lx, lu, lxx, luu, lux, reg,
                     block: int = BLOCK, interpret: bool = False) -> Tuple:
    """Riccati backward pass over a batch with shared dynamics.

    Shared (unbatched): A [N-1,n,n], B [N-1,n,m].
    Per-lane: lx [Bt,N,n], lu [Bt,N,m], lxx [Bt,N,n,n], luu [Bt,N,m,m],
    lux [Bt,N,m,n] (terminal control rows unused), reg [Bt].
    Any Bt works: the lanes are padded to a multiple of ``block``.
    Returns K [Bt,N-1,m,n], d [Bt,N-1,m], dV1 [Bt], dV2 [Bt].
    """
    Bt, N, n = lx.shape
    m = lu.shape[-1]
    N1 = N - 1
    dtype = lx.dtype
    Bp = padded_batch(Bt, block)

    def out(*shape):
        return jax.ShapeDtypeStruct(shape + (Bp,), dtype)

    with jax.named_scope("altro_riccati_backward"):
        K, d, dV, *_ = pl.pallas_call(
            _make_kernel(n, m, N1, block),
            grid=(Bp // block,),
            out_shape=[
                out(N1, m, n), out(N1, m), out(2),
                # per-lane scratch: V, Vx, VA, VB, Qxx, Qux, Quu, QuuK, Qx
                out(n, n), out(n), out(n, n), out(n, m), out(n, n),
                out(m, n), out(m, m), out(m, n), out(n),
            ],
            compiler_params=compiler_params(block),
            backend="triton",
            interpret=interpret,
            name="altro_riccati_backward",
        )(A, B, lanes_last(lx, Bp), lanes_last(lu, Bp),
          lanes_last(lxx, Bp), lanes_last(luu, Bp), lanes_last(lux, Bp),
          lanes_last(reg, Bp))
    return lanes_first(K, Bt), lanes_first(d, Bt), dV[0, :Bt], dV[1, :Bt]
