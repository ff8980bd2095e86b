"""The port's sequence parallelism (horovod_tpu_torch/parallel/ring.py,
parallel/mesh.py, the ``axes=`` collectives and ``ppermute`` of
ops/collective.py, and ``flash_attention_with_lse`` /
``flash_attention_bwd_block`` of ops/flash_attention.py) against the
JAX package's, on the same numpy inputs.

The JAX side runs under ``shard_map`` on the conftest's CPU devices, the
Pallas kernels in interpret mode; the port's kernel wrappers take their
plain versions on CPU tensors. The port's ring runs two ways: its n
shards held in one process (``ring._LocalAxis``, the counterpart of the
JAX tests' virtual mesh), and one shard on each of 4 gloo ranks of a
(data 2 x seq 2) and a (1 x 4) mesh, which must give the same bits.
fp32 throughout; the measured gaps are in PERF.md.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.ops import collective as jcoll
from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu.parallel import ring as jring
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import ring as tring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SL, H, D = 2, 16, 4, 8  # per shard: [B, SL, H, D]
N = 4                      # ranks on the ring
MESHES = [((2, 2), ("data", "seq")), ((1, 4), ("data", "seq"))]
OUT_ATOL, GRAD_ATOL = 2e-5, 5e-4  # tests/test_flash_attention.py's own
KINDS = ("dense", "flash", "ulysses")


def ring_inputs(rows, n):
    """q, k, v of ``rows`` independent sequences of ``n`` shards:
    ``[rows, B, n * SL, H, D]`` fp32 each."""
    rng = np.random.default_rng(11)
    return [rng.standard_normal((rows, B, n * SL, H, D)).astype(np.float32)
            for _ in range(3)]


def positions(n):
    return np.broadcast_to(np.arange(n * SL)[None], (B, n * SL)).copy()


def _shards(x, n):
    return list(torch.from_numpy(np.ascontiguousarray(x)).chunk(n, dim=1))


def _port(kind, axis, qs, ks, vs, pos):
    if kind == "dense":
        return tring._ring_attention(axis, qs, ks, vs, q_positions=pos,
                                     kv_positions=pos)
    if kind == "flash":
        return tring._ring_attention(axis, qs, ks, vs, use_flash=True)
    return tring._ulysses_attention(axis, qs, ks, vs)


def local_ring(kind, q, k, v, n):
    """The port over ``n`` shards in one process, one thread: the outputs
    and the gradients of sum(out ** 2) over the whole sequence."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        qs, ks, vs = ([t.requires_grad_() for t in _shards(x, n)]
                      for x in (q, k, v))
        pos = _shards(positions(n), n)
        outs = _port(kind, tring._LocalAxis(n), qs, ks, vs, pos)
        grads = torch.autograd.grad(sum((o ** 2).sum() for o in outs),
                                    qs + ks + vs)
    finally:
        torch.set_num_threads(threads)
    cat = [torch.cat(grads[i * n:(i + 1) * n], dim=1).numpy()
           for i in range(3)]
    return torch.cat(outs, dim=1).detach().numpy(), cat


def _jax_ring(kind, q, k, v, n):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    pos = jnp.asarray(positions(n))

    def attn(q, k, v, p):
        if kind == "dense":
            return jring.ring_attention(q, k, v, "seq", causal=True,
                                        q_positions=p, kv_positions=p)
        if kind == "flash":
            return jring.ring_attention(q, k, v, "seq", causal=True,
                                        use_flash=True)
        return jring.ulysses_attention(q, k, v, "seq", causal=True)

    spec = P(None, "seq")
    f = jax.jit(jax.shard_map(attn, mesh=mesh, in_specs=(spec,) * 4,
                              out_specs=spec, check_vma=False))
    out = f(q, k, v, pos)
    grads = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v, pos) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 3), (2, 1, 2)])
def test_mesh_groups_match_jax_mesh(shape):
    """Rank r's coordinates and every axes group's members, in order,
    are those of device r in ``Mesh(np.arange(n).reshape(shape))``."""
    names = ("data", "seq", "model")[:len(shape)]
    jmesh = jax.sharding.Mesh(np.arange(int(np.prod(shape))).reshape(shape),
                              names)
    groups = tmesh.mesh_groups(shape, names)
    for r in range(jmesh.devices.size):
        m = tmesh.Mesh(group=None, device=torch.device("cpu"),
                       size=jmesh.devices.size, rank=r, axis_names=names,
                       shape=shape)
        want = tuple(int(c) for c in np.argwhere(jmesh.devices == r)[0])
        assert m.coords == want
        for axes, rows in groups.items():
            # the devices that share r's coordinates off ``axes``, in
            # row-major order over ``axes``
            sel = tuple(slice(None) if a in axes else c
                        for a, c in zip(names, want))
            members = [int(x) for x in jmesh.devices[sel].reshape(-1)]
            assert members in rows and r in members
            assert sum(r in row for row in rows) == 1
        assert m.peer(names[-1], 0) == int(
            jmesh.devices[want[:-1] + (0,)])


def test_mesh_refuses_bad_axes():
    m = tmesh.Mesh(group=None, device=torch.device("cpu"), size=4, rank=1,
                   axis_names=("data", "seq"), shape=(2, 2))
    assert m.resolve(None) == ("data", "seq")
    assert m.resolve("seq") == ("seq",)
    for bad in (("seq", "data"), ("data", "data"), ("model",), ()):
        with pytest.raises(ValueError):
            m.resolve(bad)
    assert m.spans(("data", "seq")) and not m.spans("seq")
    assert tmesh.Mesh(group=None, device=torch.device("cpu"), size=4,
                      rank=1, axis_names=("data", "seq"),
                      shape=(1, 4)).spans("seq")


def test_default_positions_match_jax():
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:N]), ("seq",))
    f = jax.shard_map(lambda x: jring.default_positions("seq", B, SL),
                      mesh=mesh, in_specs=P("seq"), out_specs=P(None, "seq"),
                      check_vma=False)
    want = np.asarray(f(jnp.zeros(N)))
    got = torch.cat([tring._positions_at(i, B, SL, None) for i in range(N)],
                    dim=1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tring.default_positions(None, B, SL).numpy(),
        np.asarray(jring.default_positions(None, B, SL)))


@pytest.mark.parametrize("kv_first", [0, 8, 40])
def test_block_update_matches_jax(kv_first):
    """One online-softmax step from a running state, the K/V block at
    absolute positions ``kv_first...``: 40 is past every query, so the
    whole block is masked and rows with no earlier key stay at the
    NEG_INF sentinel."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((B, SL, H, D)).astype(np.float32)
               for _ in range(3))
    q_pos = np.broadcast_to(16 + np.arange(SL)[None], (B, SL)).copy()
    kv_pos = np.broadcast_to(kv_first + np.arange(SL)[None], (B, SL)).copy()
    m = rng.standard_normal((B, H, SL)).astype(np.float32)
    m[:, :, ::3] = -1e30  # rows that have seen no key yet
    l = np.where(m <= -1e30, 0.0, rng.uniform(0.5, 2.0, m.shape)).astype(
        np.float32)
    o = (rng.standard_normal((B, H, SL, D)) * (l[..., None] > 0)).astype(
        np.float32)
    want = jring._block_update(*(jnp.asarray(x) for x in
                                 (q, k, v, q_pos, kv_pos, m, l, o)),
                               True, 1.0 / D ** 0.5)
    got = tring._block_update(*(torch.from_numpy(x) for x in
                                (q, k, v, q_pos, kv_pos, m, l, o)),
                              True, 1.0 / D ** 0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# (q_offset, kv_offset, causal): whole blocks seen, partly seen, unseen
LSE_CASES = [(0, 0, True), (16, 0, True), (0, 8, True), (0, 16, True),
             (0, 48, True), (0, 16, False)]


def _lse_inputs():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((B, SL, H, D)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("q_off,kv_off,causal", LSE_CASES)
def test_flash_attention_with_lse_matches_jax(q_off, kv_off, causal):
    q, k, v, _ = _lse_inputs()
    j_out, j_lse = jfa.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
        q_offset=q_off, kv_offset=kv_off, block_q=8, block_k=8,
        interpret=True)
    t_out, t_lse = tfa.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        q_offset=q_off, kv_offset=kv_off)
    assert t_out.shape == (B, SL, H, D) and t_lse.shape == (B, SL, H)
    assert t_out.grad_fn is None and t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-5)
    dead = causal & (q_off + np.arange(SL) < kv_off)
    assert np.all(t_lse.numpy()[:, dead] == tfa.NEG_INF)
    assert np.all(t_out.numpy()[:, dead] == 0.0)
    with pytest.raises(TypeError):
        tfa.flash_attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                     kv_offset=torch.tensor(kv_off))


@pytest.mark.parametrize("q_off,kv_off,causal", LSE_CASES)
def test_flash_attention_bwd_block_matches_jax(q_off, kv_off, causal):
    """fp32 partials of one block against the global lse of the queries
    over keys 0..31 (two blocks), so a block the queries do not see gives
    zeros, and a partly seen one its share."""
    q, k, v, g = _lse_inputs()
    rng = np.random.default_rng(6)
    k2, v2 = (np.concatenate([x, rng.standard_normal(x.shape).astype(
        np.float32)], axis=1) for x in (k, v))
    out, lse = jfa.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k2, v2)), causal=causal,
        q_offset=q_off, block_q=8, block_k=8, interpret=True)
    delta = jnp.sum(jnp.asarray(g) * out, axis=-1)
    want = jfa.flash_attention_bwd_block(
        *(jnp.asarray(x) for x in (q, k, v, g)), lse, delta, causal=causal,
        q_offset=q_off, kv_offset=kv_off, block_q=8, block_k=8,
        interpret=True)
    got = tfa.flash_attention_bwd_block(
        *(torch.from_numpy(x) for x in (q, k, v, g)),
        torch.from_numpy(np.array(lse)), torch.from_numpy(
            np.array(delta)), causal=causal, q_offset=q_off,
        kv_offset=kv_off)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (B, SL, H, D)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    if causal and q_off + SL <= kv_off:
        assert all(np.all(a.numpy() == 0.0) for a in got)


@pytest.mark.parametrize("kind", KINDS)
def test_ring_matches_jax(kind):
    """The port's ring (dense and flash) and Ulysses over 4 shards in one
    process against the JAX package's under ``shard_map`` on 4 devices:
    the outputs and the three gradients of sum(out ** 2)."""
    q, k, v = (x[0] for x in ring_inputs(1, N))
    out, grads = local_ring(kind, q, k, v, N)
    j_out, j_grads = _jax_ring(kind, q, k, v, N)
    np.testing.assert_allclose(out, j_out, atol=OUT_ATOL)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_ring_flash_equals_dense_ring():
    """The flash ring (the kernels' plain versions per block, merged by
    lse) against the dense ring over the same shards."""
    q, k, v = (x[0] for x in ring_inputs(1, N))
    out_f, g_f = local_ring("flash", q, k, v, N)
    out_d, g_d = local_ring("dense", q, k, v, N)
    np.testing.assert_allclose(out_f, out_d, atol=OUT_ATOL)
    for a, b in zip(g_f, g_d):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)


def test_ulysses_rejects_indivisible_heads():
    qs = [torch.zeros(B, SL, 6, D)] * N
    with pytest.raises(ValueError, match="not divisible"):
        tring._ulysses_attention(tring._LocalAxis(N), qs, qs, qs)


# ---------------------------------------------------------------------------
# 4 gloo ranks: one spawn runs every check
# ---------------------------------------------------------------------------


def _collective_inputs():
    return np.random.default_rng(9).standard_normal((4, 4, 3)).astype(
        np.float32)


def _collectives(coll, x, ppermute):
    """The ``axes=`` collectives on a (data 2 x seq 2) mesh; ``coll`` is
    the port's or the JAX package's collective module."""
    return dict(
        sum_seq=coll.allreduce(x, op=coll.Sum, axes="seq"),
        avg_all=coll.allreduce(x, op=coll.Average, axes=("data", "seq")),
        ag_data=coll.allgather(x, axes="data"),
        ag_all=coll.allgather(x, axes=("data", "seq")),
        rs_seq=coll.reducescatter(x, op=coll.Sum, axes="seq"),
        a2a_data=coll.alltoall(x, axes="data"),
        bcast_seq=coll.broadcast(x, root_rank=1, axes="seq"),
        shift_seq=ppermute(x, "seq", [(0, 1), (1, 0)]),
        drop_data=ppermute(x, "data", [(0, 1)]),  # index 0 receives zeros
        rank_all=coll.mesh_rank(("data", "seq")) + 0 * x[0, 0],
        size_seq=coll.mesh_size("seq") + 0 * x[0, 0])


def _jax_collectives(x):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "seq"))

    def f(x):
        out = _collectives(jcoll, x[0], jax.lax.ppermute)
        return {k: jnp.asarray(v)[None] for k, v in out.items()}

    spec = P(("data", "seq"))
    out = jax.shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec,
                        check_vma=False)(x)
    return {k: np.asarray(v) for k, v in out.items()}


def rank_checks(out_dir):
    """Run on each of 4 gloo ranks: the meshes, the collectives and the
    three attention paths, their outputs and gradients saved to
    ``out_dir/rank<r>.npz``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import hvd_torch
    from horovod_tpu_torch.ops import collective, fusion
    res = {}
    for shape, names in MESHES:
        mesh = tmesh.build_mesh(shape, names)
        tag = "x".join(map(str, shape))
        res[f"{tag}/coords"] = np.asarray(mesh.coords)
        for axes, (_, ranks) in mesh.groups.items():
            res[f"{tag}/group/{'+'.join(axes)}"] = np.asarray(ranks)
        d, s = mesh.axis_index("data"), mesh.axis_index("seq")
        n = mesh.axis_size("seq")
        inputs = [x[d] for x in ring_inputs(shape[0], n)]
        pos = _shards(positions(n), n)[s]
        for kind in KINDS:
            q, k, v = (_shards(x, n)[s].requires_grad_() for x in inputs)
            attn = {"dense": lambda q, k, v: tring.ring_attention(
                        q, k, v, "seq", q_positions=pos, kv_positions=pos),
                    "flash": lambda q, k, v: tring.ring_attention(
                        q, k, v, "seq", use_flash=True),
                    "ulysses": lambda q, k, v: tring.ulysses_attention(
                        q, k, v, "seq")}[kind]
            out = attn(q, k, v)
            (out ** 2).sum().backward()
            res[f"{tag}/{kind}/out"] = out.detach().numpy()
            for name, t in zip("qkv", (q, k, v)):
                res[f"{tag}/{kind}/d{name}"] = t.grad.numpy()
        if shape == (2, 2):
            x = torch.from_numpy(_collective_inputs()[hvd.rank()])
            for key, val in _collectives(collective, x,
                                         collective.ppermute).items():
                res[f"coll/{key}"] = np.asarray(val)
            # an int8 wire over the seq axis: both seq ranks of a data
            # index hold its row, so their average is that row to within
            # the quantizer's step
            row = torch.from_numpy(_collective_inputs()[2 * d]).reshape(-1)
            fusion.fused_allreduce_([row], compression="int8", axes="seq")
            res["int8_seq"] = row.numpy()
            try:
                hvd_torch.require_whole_mesh(("seq",), "ZeRO-1")
            except NotImplementedError as e:
                res["refused"] = np.asarray("item 4" in str(e))
    np.savez(os.path.join(out_dir, f"rank{hvd.rank()}.npz"), **res)


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    from test_torch_ring import rank_checks
    hvd.init(device="cpu")
    rank_checks({out!r})
    hvd.shutdown()
""")


def run_ranks(src, world, timeout):
    """``src`` on ``world`` gloo ranks of a torch TCP store; each must
    exit 0 within ``timeout`` seconds."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(world),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", src], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
            p.wait()


def test_four_gloo_ranks_match_local_rotation(tmp_path):
    """On 4 gloo ranks: the meshes' coordinates and groups; the ``axes=``
    collectives and ``ppermute`` against the JAX package's under
    ``shard_map`` on a 2 x 2 mesh, exactly; ring (dense, flash) and
    Ulysses over the seq axis of (2 x 2) and (1 x 4), outputs and
    gradients bit for bit equal to the port's in-process rotation; an
    int8 fused allreduce over the seq axis alone; and ZeRO-1 over a part
    of the mesh refused."""
    run_ranks(_WORKER.format(tests=os.path.join(REPO, "tests"),
                             out=str(tmp_path)), 4, timeout=240)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for shape, names in MESHES:
        tag = "x".join(map(str, shape))
        groups = tmesh.mesh_groups(shape, names)
        n = shape[1]
        for d in range(shape[0]):
            inputs = [x[d] for x in ring_inputs(shape[0], n)]
            for kind in KINDS:
                out, grads = local_ring(kind, *inputs, n)
                for s in range(n):
                    r = d * n + s
                    res = ranks[r]
                    assert tuple(res[f"{tag}/coords"]) == (d, s)
                    for axes, rows in groups.items():
                        if axes != names:
                            assert list(res[f"{tag}/group/{'+'.join(axes)}"]) \
                                in rows
                    cut = slice(s * SL, (s + 1) * SL)
                    np.testing.assert_array_equal(
                        res[f"{tag}/{kind}/out"], out[:, cut],
                        err_msg=f"{tag} {kind} out rank {r}")
                    for name, g in zip("qkv", grads):
                        np.testing.assert_array_equal(
                            res[f"{tag}/{kind}/d{name}"], g[:, cut],
                            err_msg=f"{tag} {kind} d{name} rank {r}")
    want = _jax_collectives(_collective_inputs())
    for key, value in want.items():
        for r in range(4):
            if key == "avg_all":  # four addends of order 1: fp32
                # summation order, a few ulps of the addends
                np.testing.assert_allclose(ranks[r][f"coll/{key}"],
                                           value[r], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(ranks[r][f"coll/{key}"],
                                              value[r], err_msg=key)
    assert all(bool(res["refused"]) for res in ranks)
    x = _collective_inputs()
    for r, res in enumerate(ranks):
        want = x[2 * (r // 2)].reshape(-1)
        np.testing.assert_allclose(res["int8_seq"], want,
                                   atol=np.abs(want).max() / 127)
