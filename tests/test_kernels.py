"""The Triton kernels and the rule that picks them, on the CPU.

- interpret-mode parity at the flagship width (n=12, m=6, N=30) with a
  batch that is not a multiple of the block, so the lane padding is used;
- the kernels under an outer ``vmap`` (Pallas' batching rule adds a grid
  axis), as a nested-vmap solve would run them;
- lowering to Triton IR for the GPU (``jax.export`` for "cuda" lowers
  without a card; the Triton compile itself runs in chip_smoke.py);
- the kernel-choice rule over backend x dtype x shared x ALTRO_PALLAS.

Tests that need the card carry the ``gpu`` marker and skip here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

from altro_mpc.ops import parity
from altro_mpc.ops.dispatch import lanes_first, lanes_last, use_kernel
from altro_mpc.ops.riccati import batched_backward
from altro_mpc.ops.rollout import batched_ls_rollout

PARITY = {"backward": parity.backward_parity,
          "rollout": parity.rollout_parity}


@pytest.fixture(scope="module")
def flagship37():
    # 37 lanes: one full 32-lane block and one padded block
    return parity.make_case("flagship", 37)


@pytest.mark.parametrize("phase", ["backward", "rollout"])
def test_interpret_parity_flagship_width(flagship37, phase):
    errs = PARITY[phase](flagship37, interpret=True)
    assert all(ratio <= 1.0 for _, ratio in errs.values()), errs


def test_lane_layout_round_trip():
    x = jnp.arange(5 * 3 * 2, dtype=jnp.float32).reshape(5, 3, 2)
    y = lanes_last(x, 8)
    assert y.shape == (3, 2, 8)
    # padded lanes repeat the last scenario
    np.testing.assert_array_equal(y[..., 5:], jnp.repeat(y[..., 4:5], 3, -1))
    np.testing.assert_array_equal(lanes_first(y, 5), x)


def test_rollout_kernel_under_outer_vmap():
    """Per-group dynamics under an outer vmap: Pallas batches the kernel
    over the group axis; each group must match its own call."""
    G, Bt, N, n, m = 2, 5, 7, 4, 2
    ks = jax.random.split(jax.random.PRNGKey(3), 7)
    A = jax.random.normal(ks[0], (G, N - 1, n, n)) * 0.3
    B = jax.random.normal(ks[1], (G, N - 1, n, m)) * 0.3
    dd = jax.random.normal(ks[2], (G, N - 1, n)) * 0.1
    Xb = jax.random.normal(ks[3], (G, Bt, N, n))
    Ub = jax.random.normal(ks[4], (G, Bt, N - 1, m))
    K = jax.random.normal(ks[5], (G, Bt, N - 1, m, n)) * 0.1
    d = jax.random.normal(ks[6], (G, Bt, N - 1, m))
    args = tuple(a.astype(jnp.float32) for a in (A, B, dd, Xb, Ub, K, d))
    alphas = (1.0, 0.0)

    def run(*a):
        return batched_ls_rollout(*a, alphas, interpret=True)

    Xv, Uv = jax.vmap(run)(*args)
    for g in range(G):
        Xg, Ug = run(*(a[g] for a in args))
        np.testing.assert_allclose(Xv[g], Xg, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(Uv[g], Ug, rtol=1e-6, atol=1e-6)


def _export_for_gpu(fn, *args):
    return export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)


@pytest.mark.parametrize("phase", ["backward", "rollout"])
def test_kernels_lower_for_gpu(phase):
    pm = parity.flagship_window()
    A, B, dd = pm.dynamics.A, pm.dynamics.B, pm.dynamics.d
    N, n, m, Bt = pm.N, pm.n, pm.m, 40
    z = lambda *s: jnp.zeros((Bt,) + s, jnp.float32)  # noqa: E731
    if phase == "backward":
        exp = _export_for_gpu(
            lambda *a: batched_backward(A, B, *a), z(N, n), z(N, m),
            z(N, n, n), z(N, m, m), z(N, m, n), z())
        name = "altro_riccati_backward"
    else:
        exp = _export_for_gpu(
            lambda *a: batched_ls_rollout(A, B, dd, *a, (1.0, 0.5, 0.0)),
            z(N, n), z(N - 1, m), z(N - 1, m, n), z(N - 1, m))
        name = "altro_ls_rollout"
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text and name in text


@pytest.mark.parametrize("backend,dtype,shared,env,phase,n,expect", [
    ("gpu", jnp.float32, True, None, "backward", 10, True),
    ("gpu", jnp.float32, True, None, "backward", 12, False),
    ("gpu", jnp.float32, True, None, "rollout", 12, True),
    ("gpu", jnp.float32, True, "0", "rollout", 12, False),
    ("gpu", jnp.float32, False, None, "rollout", 12, False),
    ("gpu", jnp.float64, True, None, "rollout", 12, False),
    ("cpu", jnp.float32, True, None, "rollout", 12, False),
    ("cpu", jnp.float32, True, "1", "backward", 6, False),
    ("gpu", jnp.float32, True, None, "rollout", 17, False),
])
def test_kernel_choice_rule(monkeypatch, backend, dtype, shared, env, phase,
                            n, expect):
    if env is None:
        monkeypatch.delenv("ALTRO_PALLAS", raising=False)
    else:
        monkeypatch.setenv("ALTRO_PALLAS", env)
    # m = n / 2, the ratio of the timed shapes (flagship 12/6, rocket 6/3)
    assert use_kernel(phase, dtype, n, n // 2, shared,
                      backend=backend) is expect


@pytest.mark.parametrize("phase,n,m,expect", [
    ("backward", 10, 5, True),
    ("backward", 10, 6, False),
    ("backward", 6, 6, False),
    ("rollout", 16, 16, True),
    ("rollout", 16, 17, False),
    ("rollout", 17, 3, False),
])
def test_kernel_choice_rule_dims(monkeypatch, phase, n, m, expect):
    """State and control limits apply each on its own: a shape goes to a
    kernel only inside the box of timed (n, m)."""
    monkeypatch.delenv("ALTRO_PALLAS", raising=False)
    assert use_kernel(phase, jnp.float32, n, m, True, backend="gpu") is expect


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flagship", "rocket"])
@pytest.mark.parametrize("phase", ["backward", "rollout"])
def test_compiled_parity_on_gpu(gpu, name, phase):
    errs = PARITY[phase](parity.make_case(name, 1024))
    assert all(ratio <= 1.0 for _, ratio in errs.values()), errs
