"""The serve engine over the data ranks (horovod_tpu_torch/serve/engine.py
over a mesh of 2 gloo ranks) against the JAX package's ``ServeEngine``
on a 2-device CPU mesh and against the port's one-rank engine, on the
small fp32 LM of tests/test_torch_serve.py (weights drawn by flax,
carried across by ``convert.params_from_flax``).

One 2-rank spawn drives the same request mix through three engines:
``max_slots`` 2 and 4 split the slots over the ranks (1 + 1, 2 + 2),
``max_slots`` 3 replicates them on both ranks. The mix holds a shared
prefix (a prefix-cache hit), a prompt cached whole (a copy-on-write
fork), greedy requests and two seeded sampled ones, submitted on rank 0
at fixed iterations while others run:

* every stream equals the JAX engine's token for token (the sampled
  ones are JAX's threefry draws, bit for bit) and the one-rank port
  engine's; the greedy ones equal the single-shot oracle;
* the two ranks' streams, pools and block tables are equal, bit for
  bit, after the drive;
* rank 0's serve counters equal the one-rank engine's;
* a weight swap staged on rank 0 mid-stream reaches both ranks at the
  same iteration: their parameters, pools and streams equal a one-rank
  engine's that swapped there;
* rank 0's engine on its background thread (``start``/``stop``) ends
  rank 1's ``follow()`` with the same stream, and a dispatch that breaks
  rank 0's engine ends it too.

``hvdrun-torch -np 2 python -m horovod_tpu_torch.serve.cli`` on gloo:
rank 0 answers a ``/generate`` with the oracle's stream, and both ranks
exit 0 after a SIGTERM.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = (2, 4, 3)


# -- the mix, shared by both packages' engines and by the spawned ranks
# (which import neither JAX nor tests/test_torch_serve.py: the test hands
# them the LM's config and weights as a torch file) -----------------------

def prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, n))) for n in lengths]


def schedule(sampling, vocab):
    """``{iteration: [(prompt, max_new, sampling or None)]}``: the mix,
    submitted before that iteration's ``step()``; ``sampling`` is either
    package's ``serve.sampling`` module."""
    system, p1, p2 = prompts(51, (9, 8, 5), vocab)
    sp = sampling.SamplingParams
    return {0: [(system + [5], 6, None), (p1, 8, None),
                (p2, 8, sp(temperature=0.9, top_p=0.8, seed=7))],
            3: [(p2[::-1], 5, None)],
            7: [(system + [7, 8], 6, None), (p1, 6, None)],
            10: [(p1 + [3], 7, sp(temperature=0.7, top_p=1.0, seed=11))]}


def run_until(eng, reqs, max_steps=500):
    for _ in range(max_steps):
        if all(r.state in ("done", "failed") for r in reqs):
            return
        eng.step()
    raise AssertionError("requests not finished")


def drive(eng, sampling, vocab, max_steps=400):
    """Run the mix on ``eng`` (rank 0's, or a one-process engine);
    returns the requests in submission order."""
    plan = schedule(sampling, vocab)
    reqs = []
    for it in range(max_steps):
        for prompt, n, sp in plan.get(it, ()):
            reqs.append(eng.generate(prompt, n, sampling=sp))
        if it > max(plan) and all(r.state in ("done", "failed")
                                  for r in reqs):
            return reqs
        eng.step()
    raise AssertionError("the mix did not finish")


def swap_drive(eng, new_params, vocab):
    """Two requests, one sampled; once the first has 4 tokens, rank 0
    stages ``new_params`` (``swap_params``'s, version 9), which every
    rank swaps in at the next iteration's head. Returns the streams."""
    from horovod_tpu_torch.serve import sampling
    p, q = prompts(61, (6, 9), vocab)
    r1 = eng.generate(p, 12)
    r2 = eng.generate(q, 10, sampling=sampling.SamplingParams(
        temperature=0.8, top_p=0.9, seed=3))
    while len(r1.generated) < 4:
        eng.step()
    eng.install_weights(new_params, version=9)
    run_until(eng, [r1, r2])
    return [r1.generated, r2.generated]


def swap_params(params):
    """The weights a swap installs: ``params`` (a state_dict) with a
    seeded draw added to each floating tensor."""
    g = torch.Generator().manual_seed(1)
    return {k: v + 0.05 * torch.randn(v.shape, generator=g, dtype=v.dtype)
            if v.is_floating_point() else v for k, v in params.items()}


def counts(eng):
    ins = eng.instruments
    return {k: getattr(ins, k).value for k in (
        "submitted", "completed", "failed", "tokens",
        "cached_prefill_tokens")}


def rank_runs(out_dir):
    """On each of 2 gloo ranks: one engine over the ranks per slot
    count, and one for the weight swap; rank 0 drives, rank 1 follows.
    Saves the streams, the pool, the block tables and the swapped
    parameters."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.serve import engine as tengine
    from horovod_tpu_torch.serve import kvcache, sampling
    from horovod_tpu_torch.telemetry import registry as treg
    path = os.path.join(out_dir, "lm.pt")
    deadline = time.monotonic() + 200
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError("the test did not write the LM")
        time.sleep(0.05)
    lm = torch.load(path)
    cfg = TransformerConfig(**lm["cfg"], dtype=torch.float32)
    model = Transformer(cfg)
    model.load_state_dict(lm["params"])
    kv = kvcache.KVCacheConfig(**lm["kv"], dtype=torch.float32)
    vocab = cfg.vocab_size

    def engine(slots):
        return tengine.ServeEngine(
            model, lm["params"], kv, max_slots=slots, prefill_chunk=4,
            registry=treg.MetricsRegistry(), device="cpu", mesh=hvd.mesh())

    res = {}
    for slots in SLOTS:
        eng = engine(slots)
        res[f"{slots}/rows"] = np.asarray([eng._rows.start,
                                           eng._rows.stop])
        if hvd.rank() == 0:
            reqs = drive(eng, sampling, vocab)
            eng.stop()
            res[f"{slots}/counts"] = np.asarray(json.dumps(counts(eng)))
        else:
            reqs = []
            eng.follow(on_request=reqs.append)
        res[f"{slots}/streams"] = np.asarray(json.dumps(
            [r.generated for r in reqs]))
        res[f"{slots}/pool_k"] = eng._pool["k"].numpy()
        res[f"{slots}/pool_v"] = eng._pool["v"].numpy()
        res[f"{slots}/tables"] = eng._tables
        res[f"{slots}/dispatches"] = np.asarray(json.dumps(
            dict(eng.dispatches)))
    # a weight swap staged on rank 0 mid-stream
    eng = engine(2)
    if hvd.rank() == 0:
        streams = swap_drive(eng, lm["params1"], vocab)
        eng.stop()
    else:
        reqs = []
        eng.follow(on_request=reqs.append)
        streams = [r.generated for r in reqs]
    res["swap/streams"] = np.asarray(json.dumps(streams))
    res["swap/version"] = np.asarray(eng.weights_version)
    for name, t in sorted(eng._params.items()):
        res[f"swap/params/{name}"] = t.numpy()
    res["swap/pool_k"] = eng._pool["k"].numpy()
    # rank 0's engine on its background thread: stop() leaves the stop to
    # that thread, which sends it after its last iteration
    p, = prompts(71, (7,), vocab)
    eng = engine(4)
    if hvd.rank() == 0:
        eng.start()
        reqs = [eng.generate(p, 5)]
        deadline = time.monotonic() + 60
        while reqs[0].state not in ("done", "failed"):
            assert time.monotonic() < deadline, "the threaded engine stalled"
            time.sleep(0.01)
        eng.stop()
    else:
        reqs = []
        eng.follow(on_request=reqs.append)
    res["thread/streams"] = np.asarray(json.dumps(
        [r.generated for r in reqs]))
    # a dispatch that breaks rank 0's engine (its pool gone, in the
    # prefill) sends the stop as it raises: rank 1's follow() returns
    eng = engine(2)
    if hvd.rank() == 0:
        req = eng.generate(p, 5)
        eng._pool = None
        try:
            eng.step()
        except TypeError as e:
            res["broken/raised"] = np.asarray(type(e).__name__)
        res["broken/state"] = np.asarray(req.state)
    else:
        reqs = []
        eng.follow(on_request=reqs.append)
        res["broken/state"] = np.asarray(reqs[0].state)
    np.savez(os.path.join(out_dir, f"rank{hvd.rank()}.npz"), **res)


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    import test_torch_serve_mesh as t
    hvd.init(device="cpu")
    t.rank_runs({out!r})
    hvd.shutdown()
""")


def _start_ranks(src, world, logs):
    """``src`` on ``world`` gloo ranks, started. Their output goes to
    files under ``logs``: a pipe that nobody reads while another rank is
    waited for could fill and stall that rank inside a collective."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(world),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        log = open(os.path.join(logs, f"rank{r}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", src], env=env, cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, text=True), log))
    return procs


def _wait_ranks(procs, timeout):
    """Each started rank must exit 0 within ``timeout`` seconds."""
    try:
        for p, log in procs:
            p.wait(timeout=timeout)
            log.seek(0)
            assert p.returncode == 0, log.read()[-4000:]
    finally:
        for p, log in procs:
            p.kill()
            p.wait()
            log.close()


@pytest.fixture()
def jax_two():
    import jax

    import horovod_tpu as hvd_j
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:2])
    yield
    hvd_j.shutdown()


@pytest.fixture()
def one_torch_thread():
    """The references' LM is tiny: one intra-op thread is the fastest,
    and the test workers and the ranks on one host do not oversubscribe
    its cores (as tests/test_torch_serve.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve_test():
    """tests/test_torch_serve.py, imported where JAX may load."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_serve as ts
    return ts


def test_two_gloo_ranks_match_jax_and_one_rank(jax_two, one_torch_thread,
                                                tmp_path):
    # the ranks start while flax draws the weights, and wait for them
    procs = _start_ranks(_WORKER.format(tests=os.path.join(REPO, "tests"),
                                        out=str(tmp_path)), 2, str(tmp_path))
    ts = _serve_test()
    params1 = swap_params(ts.lm()[3])
    torch.save({"cfg": dict(vocab_size=ts.VOCAB, num_layers=ts.LAYERS,
                            num_heads=ts.HEADS, d_model=ts.D_MODEL,
                            d_ff=4 * ts.D_MODEL),
                "kv": dict(num_blocks=64, block_size=4, num_layers=ts.LAYERS,
                           num_heads=ts.HEADS,
                           head_dim=ts.D_MODEL // ts.HEADS,
                           max_blocks_per_seq=16),
                "params": ts.lm()[3], "params1": params1},
               tmp_path / "lm.tmp")
    os.replace(tmp_path / "lm.tmp", tmp_path / "lm.pt")
    # the references while the ranks run: the one-rank port engine, JAX's
    plan = schedule(ts.tsampling, ts.VOCAB)
    ones, wants = {}, {}
    for slots in SLOTS:
        ones[slots] = ts.make_engine(ts.PORT, max_slots=slots)
        wants[slots] = [r.generated for r in drive(ones[slots], ts.tsampling,
                                                   ts.VOCAB)]
        if slots != 3:  # JAX's engine splits 2 and 4 over its 2 devices
            jeng = ts.make_engine(ts.JAX, max_slots=slots)
            assert [r.generated for r in drive(
                jeng, ts.jsampling, ts.VOCAB)] == wants[slots], slots
    swap_one = ts.make_engine(ts.PORT, max_slots=2)
    swapped = swap_drive(swap_one, params1, ts.VOCAB)
    _wait_ranks(procs, timeout=240)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for slots in SLOTS:
        one, want = ones[slots], wants[slots]
        sharded = slots % 2 == 0
        b = slots // 2
        for r, res in enumerate(ranks):
            assert list(res[f"{slots}/rows"]) == (
                [r * b, (r + 1) * b] if sharded else [0, slots])
            assert json.loads(str(res[f"{slots}/streams"])) == want, \
                (slots, r)
        # the ranks' pools and tables, bit for bit
        for key in ("pool_k", "pool_v", "tables"):
            np.testing.assert_array_equal(ranks[0][f"{slots}/{key}"],
                                          ranks[1][f"{slots}/{key}"])
        assert str(ranks[0][f"{slots}/dispatches"]) == \
            str(ranks[1][f"{slots}/dispatches"])
        assert json.loads(str(ranks[0][f"{slots}/counts"])) == counts(one)
        assert one.dispatches["fork"] >= 1
        assert counts(one)["cached_prefill_tokens"] > 0
    # the weight swap: both ranks took rank 0's new weights at the same
    # iteration, as a one-rank engine does
    for res in ranks:
        assert json.loads(str(res["swap/streams"])) == swapped
        assert int(res["swap/version"]) == 9
    for name, t in swap_one._params.items():
        for res in ranks:
            np.testing.assert_array_equal(res[f"swap/params/{name}"],
                                          t.numpy())
    np.testing.assert_array_equal(ranks[0]["swap/pool_k"],
                                  ranks[1]["swap/pool_k"])
    # the threaded engine's stream on both ranks; the broken engine's
    # request failed on both, and rank 1's follow() returned
    thread = [json.loads(str(res["thread/streams"])) for res in ranks]
    assert thread[0] == thread[1] and len(thread[0][0]) == 5
    assert str(ranks[0]["broken/raised"]) == "TypeError"
    assert [str(res["broken/state"]) for res in ranks] == ["failed"] * 2
    # the greedy streams are the single-shot oracle's
    reqs = [x for it in sorted(plan) for x in plan[it]]
    for (prompt, n, sp), stream in zip(reqs, wants[2]):
        if sp is None:
            assert stream == ts.oracle(prompt, n)


def _descendants(pid):
    """Every process under ``pid``, read from ``/proc``."""
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        try:
            tasks = os.listdir(f"/proc/{p}/task")
        except OSError:
            continue
        for t in tasks:
            try:
                with open(f"/proc/{p}/task/{t}/children") as f:
                    kids = [int(k) for k in f.read().split()]
            except OSError:
                continue
            out += kids
            todo += kids
    return out


def _cli_rank_pid(root, rank):
    """The pid of the serve CLI of ``rank`` among ``root``'s
    descendants: the process that runs the module, not the launcher's
    middleman (``run/safe_exec.py``), whose command line names the module
    too and whose environment holds the same rank. A SIGTERM to the
    middleman is forwarded, and the middleman SIGKILLs the CLI 5 s later
    if it has not exited by then, which a loaded machine can take."""
    for pid in _descendants(root):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if argv[1:3] == [b"-m", b"horovod_tpu_torch.serve.cli"] and \
                f"HOROVOD_RANK={rank}".encode() in env:
            return pid
    raise AssertionError(f"no serve CLI of rank {rank} under {root}")


def test_hvdrun_two_ranks_serve_rank_zero_http(tmp_path):
    """``hvdrun-torch -np 2`` runs the CLI on 2 gloo ranks: rank 0's
    ``/generate`` streams the oracle's tokens; a SIGTERM to rank 0 ends
    both ranks with exit 0 (rank 1 leaves the signal to rank 0 and stops
    with its engine), so hvdrun exits 0."""
    import optax
    ts = _serve_test()
    _, jp, _, _ = ts.lm()
    ts._save_world(str(tmp_path), 4, ts._train_state(jp, optax.sgd(0.1), 4),
                   1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         sys.executable, "-m", "horovod_tpu_torch.serve.cli", "--ckpt-dir",
         str(tmp_path), "--port", str(port), "--device", "cpu",
         "--vocab-size", str(ts.VOCAB), "--num-layers", str(ts.LAYERS),
         "--num-heads", str(ts.HEADS), "--d-model", str(ts.D_MODEL),
         "--d-ff", str(ts.D_FF), "--dtype", "float32", "--max-slots", "2",
         "--prefill-chunk", "4", "--max-seq-len", "64", "--no-reload"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=REPO)
    try:
        p, = ts.prompts(14, (5,))
        deadline = time.time() + 90
        while True:
            try:
                lines = ts.http_generate(port, {"tokens": p,
                                                "max_new_tokens": 4})
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.time() < deadline
                time.sleep(0.2)
        assert lines[-1]["tokens"] == ts.oracle(p, 4)
        os.kill(_cli_rank_pid(proc.pid, 0), signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = out.decode()
    assert proc.returncode == 0, text[-3000:]
    assert "follows rank 0's engine" in text, text[-3000:]
