"""Pallas (Triton) kernel: the line-search ladder of closed-loop rollouts.

The parallel line search rolls out

    u = ubar + alpha d + K (x - xbar);   x+ = A x + B u + dd

for a static ladder of L step sizes. Each rollout is a strictly serial
chain of small mat-vecs over the horizon. One program owns ``blk``
scenarios (one per thread) and runs every rung's chain in a ``fori_loop``
over knots; each knot's state is read back from the output it was written
to. The SHARED dynamics (A, B, dd) are read as scalars, and only (xbar,
ubar, K, d) stream per lane. The loops over rungs and matrix rows keep
each loop body O(n^2), which bounds the Triton compile time.
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


def _make_kernel(n, m, N1, L, blk):
    def kernel(A_ref, B_ref, dd_ref, al_ref, xb_ref, ub_ref, K_ref, d_ref,
               X_ref, U_ref):
        lanes = pl.ds(pl.program_id(0) * blk, blk)

        def start(l):
            for i in range(n):
                X_ref[l, 0, i, lanes] = xb_ref[0, i, lanes]

        fori(L, start)

        def knot(k, c):
            xb = [xb_ref[k, j, lanes] for j in range(n)]

            def rung(l):
                alpha = al_ref[l]
                x = [X_ref[l, k, j, lanes] for j in range(n)]
                dx = [x[j] - xb[j] for j in range(n)]

                def u_rows(i):              # u = ubar + alpha d + K dx
                    U_ref[l, k, i, lanes] = (
                        ub_ref[k, i, lanes] + alpha * d_ref[k, i, lanes]
                        + sum(K_ref[k, i, j, lanes] * dx[j]
                              for j in range(n)))

                fori(m, u_rows)
                u = [U_ref[l, k, j, lanes] for j in range(m)]

                def x_rows(i):              # x+ = A x + B u + dd
                    X_ref[l, k + 1, i, lanes] = (
                        dd_ref[k, i]
                        + sum(A_ref[k, i, j] * x[j] for j in range(n))
                        + sum(B_ref[k, i, j] * u[j] for j in range(m)))

                fori(n, x_rows)

            fori(L, rung)
            return c

        jax.lax.fori_loop(np.int32(0), np.int32(N1), knot, None)

    return kernel


def batched_ls_rollout(A, B, dd, Xbar, Ubar, K, d, alphas,
                       block: int = BLOCK,
                       interpret: bool = False) -> Tuple:
    """Ladder rollouts over a batch.

    Shared (unbatched): A [N-1,n,n], B [N-1,n,m], dd [N-1,n].
    Per-lane: Xbar [Bt,N,n], Ubar/d [Bt,N-1,m], K [Bt,N-1,m,n].
    alphas: static tuple of python floats (the ladder).
    Any Bt works: the lanes are padded to a multiple of ``block``.
    Returns Xs [Bt,L,N,n], Us [Bt,L,N-1,m].
    """
    Bt, N, n = Xbar.shape
    m = Ubar.shape[-1]
    N1 = N - 1
    alphas = tuple(float(a) for a in alphas)
    L = len(alphas)
    dtype = Xbar.dtype
    Bp = padded_batch(Bt, block)

    with jax.named_scope("altro_ls_rollout"):
        X, U = pl.pallas_call(
            _make_kernel(n, m, N1, L, block),
            grid=(Bp // block,),
            out_shape=[
                jax.ShapeDtypeStruct((L, N, n, Bp), dtype),
                jax.ShapeDtypeStruct((L, N1, m, Bp), dtype),
            ],
            compiler_params=compiler_params(block),
            backend="triton",
            interpret=interpret,
            name="altro_ls_rollout",
        )(A, B, dd, jnp.asarray(alphas, dtype), lanes_last(Xbar, Bp),
          lanes_last(Ubar, Bp),
          lanes_last(K, Bp), lanes_last(d, Bp))
    return lanes_first(X, Bt), lanes_first(U, Bt)
