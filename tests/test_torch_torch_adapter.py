"""The port's classic torch adapter (horovod_tpu_torch/torch/) against
the JAX package's (horovod_tpu/torch/), each on 2 ranks of its own
launcher's ``run()``, with the same seeded inputs: every collective, the
async and in-place forms, ``broadcast_object``, the gradients through
allreduce, allgather and broadcast, an uneven ``join``, and a seeded MLP
through ``DistributedOptimizer`` (with and without fp16 compression),
``broadcast_parameters`` and ``broadcast_optimizer_state``: the two
adapters' results bit for bit, and the collectives bit for bit numpy's.
The two spawns run side by side; each package's workers load their own
core only."""

import sys
import types

import numpy as np
import pytest
import torch

import adapter_pair


def _body(package, init_kw):
    """One rank's checks of ``package``'s torch adapter; returns plain
    lists, whose floats are the tensors' exact values. The port also
    runs what the JAX adapter cannot: the MLP under Adam, whose 0-d
    ``step`` state its ``broadcast_optimizer_state`` cannot lend in place
    (its contiguity check copies a 0-d array), and ``allreduce_`` with
    scale factors (it hands ``prescale_factor`` to the core by that
    name)."""
    import importlib

    import numpy as np
    import torch
    hvd = importlib.import_module(f"{package}.torch")
    port_only = package == "horovod_tpu_torch"
    hvd.init(**init_kw)
    r, n = hvd.rank(), hvd.size()
    out = {"rank": r, "size": n}
    if port_only:  # the core starts at the first collective, not here
        out["core_at_init"] = importlib.import_module(
            f"{package}._core").is_initialized()

    def val(t):
        return t.detach().cpu().numpy().tolist()

    x = torch.from_numpy(np.random.default_rng(100 + r).standard_normal(
        (4, 3)).astype(np.float32))
    out["ar.avg"] = val(hvd.allreduce(x, name="ar.avg"))
    out["ar.sum"] = val(hvd.allreduce(x, average=False, name="ar.sum"))
    out["ar.max"] = val(hvd.allreduce(x, op=hvd.Max, name="ar.max"))
    out["ar.min"] = val(hvd.allreduce(x, op=hvd.Min, name="ar.min"))
    out["ar.fp16"] = val(hvd.allreduce(
        x, name="ar.fp16", compression=hvd.Compression.fp16))
    out["ar.scaled"] = val(hvd.allreduce(
        x, average=False, name="ar.scaled", prescale_factor=0.5,
        postscale_factor=3.0))
    out["ag"] = val(hvd.allgather(torch.full((r + 1, 2), float(r) + 0.5),
                                  name="ag"))
    out["bc"] = val(hvd.broadcast(x, 1, name="bc"))
    out["a2a"] = val(hvd.alltoall(
        torch.arange(4 * n).reshape(2 * n, 2) + 100 * r, name="a2a"))
    handles = [hvd.allreduce_async(x * (i + 1), name=f"async.{i}")
               for i in range(3)]
    out["async"] = [val(hvd.synchronize(h)) for h in handles]
    y = x.clone()
    assert hvd.allreduce_(y, name="ip.ar") is y
    out["ip.ar"] = val(y)
    z = x.clone()
    hvd.synchronize(hvd.broadcast_async_(z, 1, name="ip.bc"))
    out["ip.bc"] = val(z)
    nc = x.clone().t()  # not contiguous: reduced from a copy, copied back
    hvd.allreduce_(nc, average=False, name="ip.nc")
    out["ip.nc"] = val(nc)
    out["obj"] = hvd.broadcast_object({"rank": r, "list": [1, 2.5]},
                                      root_rank=1, name="obj")
    # gradients through the collectives
    g = torch.ones(3, requires_grad=True)
    hvd.allreduce(g * float(r + 1), name="grad.ar").sum().backward()
    out["grad.ar"] = val(g.grad)
    g = torch.ones(r + 1, 2, requires_grad=True)
    gathered = hvd.allgather(g * 2.0, name="grad.ag")
    weights = torch.arange(1.0, gathered.shape[0] + 1).reshape(-1, 1)
    (gathered * weights).sum().backward()
    out["grad.ag"] = val(g.grad)
    g = torch.ones(2, requires_grad=True)
    (hvd.broadcast(g, 0, name="grad.bc") * float(r + 2)).sum().backward()
    out["grad.bc"] = val(g.grad)
    # a seeded MLP: rank 1 starts perturbed, the startup broadcasts make
    # it rank 0's; each rank trains on its own rows
    runs = [("none", None, "sgd"), ("fp16", hvd.Compression.fp16, "sgd")]
    for tag, comp, kind in runs + ([("adam", None, "adam")]
                                   if port_only else []):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                    torch.nn.Linear(16, 4))
        if r == 1:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0.25)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        inner = (torch.optim.Adam(model.parameters(), lr=0.01)
                 if kind == "adam" else
                 torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9))
        opt = hvd.DistributedOptimizer(
            inner,
            named_parameters=[(f"{tag}.{k}", p)
                              for k, p in model.named_parameters()],
            compression=comp)
        rng = np.random.default_rng(200 + r)
        xs = torch.from_numpy(rng.standard_normal((16, 8)).astype(
            np.float32))
        ys = torch.from_numpy(rng.standard_normal((16, 4)).astype(
            np.float32))
        losses = []
        for step in range(4):
            if step == 3:
                # rank 1's state drifts; root's comes back
                if r == 1:
                    for st in opt.state.values():
                        for v in st.values():
                            v.add_(1.0)
                hvd.broadcast_optimizer_state(opt, root_rank=0)
            opt.zero_grad()
            loss = torch.nn.functional.mse_loss(model(xs), ys)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        out[f"mlp.{tag}"] = {
            "losses": losses,
            "params": [val(p) for p in model.parameters()],
            "state": [{k: val(v) for k, v in sorted(st.items())}
                      for st in opt.state.values()]}
    if port_only:
        y = x.clone()
        hvd.allreduce_(y, average=False, name="ip.scaled",
                       prescale_factor=0.5, postscale_factor=3.0)
        out["ip.scaled"] = val(y)
    try:
        hvd.allreduce(torch.ones(2, dtype=torch.bfloat16), name="bf16")
        out["bf16"] = None
    except TypeError as e:
        out["bf16"] = type(e).__name__
    # an uneven join: rank 0 runs out of data first
    if r > 0:
        hvd.allreduce(x, name="late")
    out["join"] = hvd.join()
    hvd.shutdown()
    return out


def _adapters_agree_bit_for_bit(ranks):
    assert [o["rank"] for o in ranks.port] == [0, 1]
    for mine, ref in zip(ranks.port, ranks.jax):
        assert sorted(mine) == sorted(
            set(ref) | {"mlp.adam", "ip.scaled", "core_at_init"})
        assert mine["core_at_init"] is False
        for key in ref:
            assert mine[key] == ref[key], key


def _collectives_equal_numpy(ranks):
    xs = [np.random.default_rng(100 + r).standard_normal((4, 3)).astype(
        np.float32) for r in range(2)]
    total = xs[0] + xs[1]
    for r, out in enumerate(ranks.port):
        assert out["ar.sum"] == total.tolist()
        assert out["ar.avg"] == (total * np.float32(0.5)).tolist()
        assert out["ar.max"] == np.maximum(*xs).tolist()
        assert out["ar.min"] == np.minimum(*xs).tolist()
        assert out["bc"] == xs[1].tolist()
        assert out["ip.bc"] == xs[1].tolist()
        assert out["ip.ar"] == out["ar.avg"]
        assert out["ip.nc"] == total.T.tolist()
        assert out["ip.scaled"] == out["ar.scaled"] == (
            (xs[0] * np.float32(0.5) + xs[1] * np.float32(0.5))
            * np.float32(3.0)).tolist()
        assert out["async"] == [
            ((xs[0] * np.float32(i + 1) + xs[1] * np.float32(i + 1))
             * np.float32(0.5)).tolist() for i in range(3)]
        assert out["ag"] == [[0.5, 0.5], [1.5, 1.5], [1.5, 1.5]]
        a2a = [np.arange(8).reshape(4, 2) + 100 * s for s in range(2)]
        assert out["a2a"] == np.concatenate(
            [a[2 * r:2 * r + 2] for a in a2a]).tolist()
        assert out["obj"] == {"rank": 1, "list": [1, 2.5]}
        # d/dx of the average over both ranks times r+1 (the backward
        # averages the cotangents of ones), d/dg of rows
        # weighted by their gathered index, and the root's summed
        # cotangent (zero elsewhere)
        assert out["grad.ar"] == [r + 1.0] * 3
        assert out["grad.ag"] == ([[4.0, 4.0]] if r == 0
                                  else [[8.0, 8.0], [12.0, 12.0]])
        assert out["grad.bc"] == ([5.0, 5.0] if r == 0 else [0.0, 0.0])
        assert out["bf16"] == "TypeError"
        assert out["join"] == 1


def _ranks_train_alike(ranks):
    """After the startup broadcasts both ranks hold rank 0's weights, and
    each step applies the same averaged gradient: the ranks' parameters
    and optimizer state agree bit for bit, with and without fp16, and
    under Adam, whose ``step`` counters are 0-d tensors."""
    for tag in ("none", "fp16", "adam"):
        a, b = (out[f"mlp.{tag}"] for out in ranks.port)
        assert a["params"] == b["params"]
        assert a["state"] == b["state"] and a["state"]
        assert a["losses"] != b["losses"]  # each rank's own rows


def _one_process_adam():
    """The Adam MLP of ``_body`` in one process, without the adapter: each
    step computes both ranks' gradients on their seeded rows and steps on
    ``(g0 + g1) / 2``, the 2-rank average (one fp32 add, then an exact
    halving); the state ``broadcast_optimizer_state`` brings back at step
    3 is rank 0's, this run's own. Returns each rank's losses, the
    parameters and the state, as ``_body`` lists them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the workers run (OMP_NUM_THREADS=1)
    try:
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                    torch.nn.Linear(16, 4))
        opt = torch.optim.Adam(model.parameters(), lr=0.01)
        rows = []
        for r in range(2):
            rng = np.random.default_rng(200 + r)
            rows.append([torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)) for shape in ((16, 8), (16, 4))])
        losses = [[], []]
        for _ in range(4):
            grads = []
            for r, (xs, ys) in enumerate(rows):
                model.zero_grad(set_to_none=True)
                loss = torch.nn.functional.mse_loss(model(xs), ys)
                loss.backward()
                losses[r].append(loss.item())
                grads.append([p.grad for p in model.parameters()])
            for p, g0, g1 in zip(model.parameters(), *grads):
                p.grad = (g0 + g1) / 2
            opt.step()
    finally:
        torch.set_num_threads(threads)
    return losses, {
        "params": [p.detach().numpy().tolist() for p in model.parameters()],
        "state": [{k: v.numpy().tolist() for k, v in sorted(st.items())}
                  for st in opt.state.values()]}


def _adam_matches_one_process_adam(ranks):
    """The port-only Adam run (its 0-d ``step`` counters lent to the core
    as 1-element views, rank 1's drifted state replaced by rank 0's) is
    bit for bit the plain one-process run: losses, parameters and the
    optimizer's state, ``step`` included."""
    losses, ref = _one_process_adam()
    for r, out in enumerate(ranks.port):
        got = out["mlp.adam"]
        assert got["losses"] == losses[r], r
        assert got["params"] == ref["params"], r
        assert got["state"] == ref["state"], r
        assert all(st["step"] == 4.0 for st in got["state"])


def test_adapters_on_two_ranks():
    """Both adapters' 2 ranks, spawned side by side once, held by every
    check above."""
    jax, port = adapter_pair.run_both(sys.modules[__name__], _body)
    ranks = types.SimpleNamespace(jax=jax, port=port)
    _adapters_agree_bit_for_bit(ranks)
    _collectives_equal_numpy(ranks)
    _ranks_train_alike(ranks)
    _adam_matches_one_process_adam(ranks)


def test_public_names_equal_the_jax_adapter():
    import horovod_tpu.torch as jax_adapter

    import horovod_tpu_torch.torch as port_adapter
    assert port_adapter.__all__ == jax_adapter.__all__
    for name in port_adapter.__all__:
        assert hasattr(port_adapter, name), name


def test_ops_refuse_without_init_or_without_a_core(monkeypatch):
    """Before ``init()`` the ops raise; a job of more than one rank whose
    core did not start raises too, never stepping down to a core of one
    rank."""
    from horovod_tpu_torch import _core, basics
    from horovod_tpu_torch import torch as hvd
    basics.shutdown()
    with pytest.raises(RuntimeError, match="init"):
        hvd.allreduce(torch.ones(2))
    monkeypatch.setattr(basics, "_state", types.SimpleNamespace(
        initialized=True, config=types.SimpleNamespace(
            size=2, controller_addr=None), controller=None))
    monkeypatch.setattr(_core, "is_initialized", lambda: False)
    monkeypatch.setattr(_core, "init", None)  # must not be reached
    with pytest.raises(RuntimeError, match="runs no native core"):
        hvd.allreduce(torch.ones(2))
    with pytest.raises(RuntimeError, match="runs no native core"):
        hvd.join()
