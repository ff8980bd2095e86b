"""The port's Adasum (horovod_tpu_torch/ops/adasum.py, and ``op=Adasum``
through ops/collective.py, ops/fusion.py and DistributedOptimizer)
against the JAX package's, and both against the JAX package's own NumPy
models (``adasum_combine_np``, ``adasum_tree_np``,
``hierarchical_adasum_np``).

The port's tree and two-level composite run over every rank of a mesh
held in one process (``parallel.axis``), the JAX functions under
``shard_map`` on the conftest's CPU devices. Bound: rtol 1e-5, atol 1e-6
(the dot products and norms sum in another order); the measured gaps are
in PERF.md. The 4-rank gloo checks (the group forms bit for bit, the
dryrun's Adasum step) run in tests/test_torch_hierarchical.py's spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd_t
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu_torch.ops import adasum as tadasum
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.parallel import axis as taxis

RTOL, ATOL = 1e-5, 1e-6
NAMES = ("dcn", "data")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _pairs():
    rng = np.random.default_rng(7)
    a = rng.standard_normal(37).astype(np.float32)
    b = rng.standard_normal(37).astype(np.float32)
    return {
        "orthogonal": (np.array([1.0, 0.0], np.float32),
                       np.array([0.0, 1.0], np.float32)),
        "identical": (np.array([2.0, -3.0, 1.0], np.float32),) * 2,
        "random": (a, b),
        "zero_norm": (np.zeros(4, np.float32),
                      np.array([1.0, 2.0, 3.0, 4.0], np.float32)),
        "both_zero": (np.zeros(3, np.float32),) * 2,
        "matrix": (a[:36].reshape(6, 6), b[:36].reshape(6, 6)),
    }


@pytest.mark.parametrize("case", list(_pairs()))
def test_combine_matches_jax_and_numpy(case):
    a, b = _pairs()[case]
    got = tadasum.adasum_combine(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == a.shape and got.dtype == torch.float32
    _close(got, jadasum.adasum_combine(jnp.asarray(a), jnp.asarray(b)))
    _close(got, jadasum.adasum_combine_np(a, b))
    if case == "orthogonal":
        np.testing.assert_array_equal(got.numpy(), [1.0, 1.0])
    if case in ("identical", "both_zero"):
        np.testing.assert_array_equal(got.numpy(), a + b if case ==
                                      "both_zero" else a)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_combine_takes_dot_products_in_fp32(dtype):
    """A 16-bit pair: the dot and norms in fp32 (as the JAX operator), the
    result in the operands' dtype."""
    rng = np.random.default_rng(8)
    a, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    got = tadasum.adasum_combine(ta, tb)
    assert got.dtype == dtype
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    want = jadasum.adasum_combine(jnp.asarray(ta.float().numpy()).astype(jd),
                                  jnp.asarray(tb.float().numpy()).astype(jd))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)


def _jax_tree(vals, n):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))
    f = jax.shard_map(lambda v: jadasum.adasum_allreduce(v[0], ("data",))[
        None], mesh=mesh, in_specs=P("data"), out_specs=P("data"),
        check_vma=False)
    return np.asarray(f(vals))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_tree_matches_jax_and_numpy(n):
    """The XOR tree over n ranks: every rank ends with the same vector,
    the JAX tree's and the NumPy schedule model's."""
    vals = np.random.default_rng(n).standard_normal((n, 33)).astype(
        np.float32)
    got = tadasum._adasum_tree([torch.from_numpy(v) for v in vals],
                               taxis.LocalAxis(n))
    want = _jax_tree(vals, n)
    ref = jadasum.adasum_tree_np(list(vals))
    for r in range(n):
        np.testing.assert_array_equal(got[r].numpy(), got[0].numpy())
        _close(got[r], want[r])
        _close(got[r], ref)


def test_tree_of_identical_gradients_is_the_gradient():
    g = np.random.default_rng(2).standard_normal(16).astype(np.float32)
    got = tadasum._adasum_tree([torch.from_numpy(g)] * 4, taxis.LocalAxis(4))
    for t in got:
        np.testing.assert_array_equal(t.numpy(), g)


@pytest.mark.parametrize("n", [3, 6])
def test_non_power_of_two_raises(n):
    xs = [torch.ones(4)] * n
    with pytest.raises(ValueError, match="power-of-2"):
        tadasum._adasum_tree(xs, taxis.LocalAxis(n))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))
    with pytest.raises(ValueError, match="power-of-2"):
        jax.shard_map(lambda v: jadasum.adasum_allreduce(v, ("data",)),
                      mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                      check_vma=False)(jnp.ones((n, 4)))


def _jax_hier(vals, shape, fn):
    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
        NAMES)
    f = jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                      in_specs=P(NAMES), out_specs=P(NAMES),
                      check_vma=False)
    return np.asarray(f(vals))


HIER_CASES = {  # (dcn, data), length
    "2x2": ((2, 2), 12),
    "2x4": ((2, 4), 12),
    "2x3-unpadded": ((2, 3), 13),
    "4x2-unpadded": ((4, 2), 4 * 2 + 3),
    "1x4": ((1, 4), 10),
    "2x1": ((2, 1), 9),
}


@pytest.mark.parametrize("case", list(HIER_CASES))
def test_hierarchical_matches_jax_and_numpy(case):
    """The two-level composite (sum-scatter over data, the tree per chunk
    across dcn, gather, / local_size) over a (dcn x data) mesh, lengths
    that need padding included, against JAX's ``adasum_allreduce(x,
    ("dcn", "data"))`` and ``hierarchical_adasum_np``."""
    shape, length = HIER_CASES[case]
    n = int(np.prod(shape))
    vals = np.random.default_rng(length).standard_normal(
        (n, length)).astype(np.float32)
    ax = taxis.local_axes(shape, NAMES)
    got = tadasum._hierarchical_adasum([torch.from_numpy(v) for v in vals],
                                       [ax["data"]], ax["dcn"])
    want = _jax_hier(vals, shape,
                     lambda v: jadasum.adasum_allreduce(v, NAMES))
    ref = jadasum.hierarchical_adasum_np(vals.reshape(shape + (length,)))
    for r in range(n):
        _close(got[r], want[r])
        _close(got[r], ref)


def test_hierarchical_identical_gradients_is_identity():
    """Node sums of identical gradients combine to themselves, and the
    division by local_size gives the gradient back."""
    g = np.random.default_rng(4).standard_normal(16).astype(np.float32)
    ax = taxis.local_axes((2, 4), NAMES)
    got = tadasum._hierarchical_adasum([torch.from_numpy(g)] * 8,
                                       [ax["data"]], ax["dcn"])
    want = _jax_hier(np.tile(g, (8, 1)), (2, 4),
                     lambda v: jadasum.adasum_allreduce(v, NAMES))
    for r in range(8):
        _close(got[r], g)
        _close(got[r], want[r])


def test_hierarchical_bf16_divides_in_fp32():
    vals = np.random.default_rng(5).standard_normal((4, 10)).astype(
        np.float32)
    xs = [torch.from_numpy(v).to(torch.bfloat16) for v in vals]
    ax = taxis.local_axes((2, 2), NAMES)
    got = tadasum._hierarchical_adasum(xs, [ax["data"]], ax["dcn"])
    assert got[0].dtype == torch.bfloat16
    want = _jax_hier(np.stack([x.float().numpy() for x in xs]).astype(
        jnp.bfloat16), (2, 2), lambda v: jadasum.adasum_allreduce(v, NAMES))
    np.testing.assert_allclose(got[0].float().numpy(),
                               want[0].astype(np.float32), rtol=2 ** -6,
                               atol=1e-6)


def test_world_one_is_the_identity_and_the_refusals_hold():
    """At world 1 ``allreduce(op=Adasum)`` and the fused buckets return
    their input; the chunked wire refuses Adasum with the JAX package's
    ``ValueError``."""
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        x = torch.randn(9)
        np.testing.assert_array_equal(
            hvd_t.allreduce(x, op=hvd_t.Adasum).numpy(), x.numpy())
        leaves = [torch.randn(5), torch.randn(2, 3)]
        before = [t.clone() for t in leaves]
        tfusion.fused_allreduce_(leaves, op=hvd_t.Adasum)
        for a, b in zip(leaves, before):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        with pytest.raises(ValueError, match="chunked wire format"):
            hvd_t.DistributedOptimizer(
                torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=1),
                op=hvd_t.Adasum, compression="int8")
        with pytest.raises(ValueError, match="chunked wire format"):
            tfusion.fused_allreduce_([torch.ones(2)], op=hvd_t.Adasum,
                                     compression="int8")
    finally:
        hvd_t.shutdown()


def measured_gaps():
    """The largest gaps of the cases above, for PERF.md: ``{what: (max
    abs, max abs / max |reference|)}`` against JAX and the NumPy
    models."""
    out = {}

    def note(what, got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        gap = float(np.abs(got - want).max())
        old = out.get(what, (0.0, 0.0))
        out[what] = (max(old[0], gap),
                     max(old[1], gap / max(float(np.abs(want).max()),
                                           1e-30)))

    for a, b in _pairs().values():
        got = tadasum.adasum_combine(torch.from_numpy(a), torch.from_numpy(b))
        note("combine vs JAX", got, jadasum.adasum_combine(jnp.asarray(a),
                                                           jnp.asarray(b)))
        note("combine vs numpy", got, jadasum.adasum_combine_np(a, b))
    for n in (2, 4, 8):
        vals = np.random.default_rng(n).standard_normal((n, 33)).astype(
            np.float32)
        got = tadasum._adasum_tree([torch.from_numpy(v) for v in vals],
                                   taxis.LocalAxis(n))[0]
        note("tree vs JAX", got, _jax_tree(vals, n)[0])
        note("tree vs numpy", got, jadasum.adasum_tree_np(list(vals)))
    for shape, length in HIER_CASES.values():
        n = int(np.prod(shape))
        vals = np.random.default_rng(length).standard_normal(
            (n, length)).astype(np.float32)
        ax = taxis.local_axes(shape, NAMES)
        got = tadasum._hierarchical_adasum(
            [torch.from_numpy(v) for v in vals], [ax["data"]], ax["dcn"])[0]
        note("two-level vs JAX", got, _jax_hier(
            vals, shape, lambda v: jadasum.adasum_allreduce(v, NAMES))[0])
        note("two-level vs numpy", got, jadasum.hierarchical_adasum_np(
            vals.reshape(shape + (length,))))
    return out


if __name__ == "__main__":
    # python tests/test_torch_adasum.py: the measured gaps (JAX_PLATFORMS
    # and the virtual devices as tests/conftest.py sets them)
    for what, (gap, rel) in measured_gaps().items():
        print(f"{what}: max abs {gap:.3e}, {rel:.3e} of max |reference|")
