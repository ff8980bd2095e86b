"""The port's serving plane (horovod_tpu_torch/serve, the transformer's
decode branch) against the JAX package's (horovod_tpu/serve) on the same
weights: a 2-layer, d 64, 4-head LM over a vocabulary of 128, fp32,
drawn by flax from a seed and carried across with
``convert.params_from_flax``.

* the decode branch: logits and new K/V against JAX's ``kv_cache=``
  branch (rtol 1e-5, atol 1e-6) and against the port's own full forward;
  the three guards raise alike;
* the KV pool's device functions bit for bit JAX's on one pool and
  table; ``BlockAllocator`` and ``PrefixCache`` the same results and the
  same raises over one seeded sequence of operations;
* sampling: JAX's threefry words bit for bit, the Gumbel draws within 2
  ulp (plus the 2^-22 a one-ulp ``log`` difference carries), the same
  token ids;
* the engine: greedy and seeded streams equal to the JAX engine's and to
  the single-shot oracle; on a fake clock, the same per-iteration
  scheduler log (admission order, prefill preemption, backpressure,
  eviction, prefix-cache hits and forks); the replay of a continuation
  bit for bit the unbroken stream, in bf16 too;
* the loader: a JAX-written manifest loads bit for bit (ZeRO rows
  skipped), a port-written one too; shape mismatches are loud; a corrupt
  newest step falls back; the ``ReloadWatcher`` poll cycle is JAX's;
* HTTP: ``/generate`` streams the JAX server's tokens; bad requests get
  400; a draining ``/healthz`` 503; ``/metrics`` counts what was served.
"""

import functools
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import ckpt as jckpt
from horovod_tpu.ckpt import manifest as jmanifest
from horovod_tpu.ckpt import sharded as jsharded
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import zero as jzero
from horovod_tpu.serve import engine as jengine
from horovod_tpu.serve import kvcache as jkv
from horovod_tpu.serve import loader as jloader
from horovod_tpu.serve import sampling as jsampling
from horovod_tpu.serve import server as jserver
from horovod_tpu.telemetry import registry as jreg
from horovod_tpu.training import TrainState
from horovod_tpu_torch import ckpt, convert
from horovod_tpu_torch.ckpt import manifest
from horovod_tpu_torch.ckpt import sharded
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.serve import engine as tengine
from horovod_tpu_torch.serve import kvcache as tkv
from horovod_tpu_torch.serve import loader as tloader
from horovod_tpu_torch.serve import sampling as tsampling
from horovod_tpu_torch.serve import server as tserver
from horovod_tpu_torch.telemetry import registry as treg

VOCAB, LAYERS, HEADS, D_MODEL, D_FF = 128, 2, 4, 64, 256
DEV = torch.device("cpu")
# fp32 against fp32 in another summation order: a logit (|x| up to ~3)
# sums 64-term dot products, so elements near 0 part by ~1e-6 absolute
# (measured 2.3e-6)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The LM is tiny: one intra-op thread is the fastest, and several
    test workers on one host do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the two packages side by side -------------------------------------------

class Side:
    """One package's serving modules, so a scenario runs on either."""

    def __init__(self, engine, kv, sampling, registry, port):
        self.engine, self.kv, self.sampling = engine, kv, sampling
        self.registry, self.port = registry, port


JAX = Side(jengine, jkv, jsampling, jreg, port=False)
PORT = Side(tengine, tkv, tsampling, treg, port=True)


@functools.lru_cache(maxsize=None)
def lm(seed=0, layers=LAYERS, heads=HEADS, d_model=D_MODEL, moe_every=0,
       dtype="float32"):
    """``(jax model, flax params, port model, port params)`` of one seeded
    LM: flax draws the weights, ``convert`` carries them across."""
    jcfg = JConfig(vocab_size=VOCAB, num_layers=layers, num_heads=heads,
                   d_model=d_model, d_ff=4 * d_model,
                   dtype=getattr(jnp, dtype), flash_attention=False,
                   moe_every=moe_every, num_experts=4,
                   moe_capacity_factor=4.0)
    jm = JTransformer(jcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = TransformerConfig(vocab_size=VOCAB, num_layers=layers,
                            num_heads=heads, d_model=d_model,
                            d_ff=4 * d_model, dtype=getattr(torch, dtype),
                            moe_every=moe_every, num_experts=4,
                            moe_capacity_factor=4.0)
    model = Transformer(cfg)
    params = convert.params_from_flax(jp, cfg)
    model.load_state_dict(params)
    return jm, jp, model, params


def kv_config(side, num_blocks=64, block_size=4, mbps=16, dtype="float32",
              layers=LAYERS, heads=HEADS, d_model=D_MODEL):
    mod = torch if side.port else jnp
    return side.kv.KVCacheConfig(
        num_blocks=num_blocks, block_size=block_size, num_layers=layers,
        num_heads=heads, head_dim=d_model // heads, max_blocks_per_seq=mbps,
        dtype=getattr(mod, dtype))


def make_engine(side, max_slots=4, prefill_chunk=4, clock=time.monotonic,
                dtype="float32", kv=None, registry=None, **kw):
    """An engine of ``side`` on ``lm()``'s weights (port: on the CPU)."""
    jm, jp, model, params = lm(dtype=dtype)
    kv = kv or {}
    cfg = kv_config(side, dtype=dtype, **kv)
    reg = registry if registry is not None else side.registry.MetricsRegistry()
    if side.port:
        return side.engine.ServeEngine(
            model, params, cfg, max_slots=max_slots,
            prefill_chunk=prefill_chunk, clock=clock, registry=reg,
            device=DEV, **kw)
    return side.engine.ServeEngine(
        jm, jp, cfg, max_slots=max_slots, prefill_chunk=prefill_chunk,
        clock=clock, registry=reg, **kw)


def oracle(prompt, n, dtype="float32"):
    """Hand-fed single-shot greedy decode on the port: the full forward
    re-run per token, no cache."""
    _, _, model, _ = lm(dtype=dtype)
    out = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([out]))
            out.append(int(torch.argmax(logits[0, -1])))
    return out[len(prompt):]


def run_until(eng, reqs, max_steps=500):
    for _ in range(max_steps):
        if all(r.state in ("done", "failed") for r in reqs):
            return
        eng.step()
    raise AssertionError(f"requests not finished after {max_steps} "
                         f"iterations: {[(r.id, r.state) for r in reqs]}")


def assert_no_leak(eng):
    cached = eng.prefix_cache.size if eng.prefix_cache is not None else 0
    assert eng.allocator.in_use == cached
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    assert eng.allocator.in_use == 0
    assert eng.allocator.available == eng.allocator.capacity


def prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, VOCAB, n))) for n in lengths]


# -- the decode branch ---------------------------------------------------------

@pytest.mark.parametrize("moe_every", [0, 2])
def test_decode_branch_matches_jax_and_the_full_forward(moe_every):
    """Tokens fed one at a time through ``kv_cache``: logits and new K/V
    equal JAX's branch on the same cache, and the logits the port's own
    full forward."""
    jm, jp, model, _ = lm(moe_every=moe_every)
    L, H, Dh, S, ctx = LAYERS, HEADS, D_MODEL // HEADS, 10, 16
    toks = np.random.default_rng(1).integers(0, VOCAB, (2, S))
    with torch.no_grad():
        full = model(torch.from_numpy(toks)).numpy()
    ck = np.zeros((L, 2, ctx, H, Dh), np.float32)
    cv = np.zeros_like(ck)
    for t in range(S):
        lengths = np.array([t, t], np.int32)
        jpos = jkv.context_positions(jnp.asarray(lengths), ctx)
        tpos = tkv.context_positions(torch.from_numpy(lengths), ctx)
        np.testing.assert_array_equal(np.asarray(jpos), tpos.numpy())
        pos = np.full((2, 1), t, np.int32)
        jl, (jk, jv) = jm.apply({"params": jp}, jnp.asarray(toks[:, t:t + 1]),
                                positions=jnp.asarray(pos),
                                kv_cache=(jnp.asarray(ck), jnp.asarray(cv),
                                          jpos))
        with torch.no_grad():
            tl, (tk, tv) = model(torch.from_numpy(toks[:, t:t + 1]),
                                 positions=torch.from_numpy(pos),
                                 kv_cache=(torch.from_numpy(ck),
                                           torch.from_numpy(cv), tpos))
        for got, want in ((tl, jl), (tk, jk), (tv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=ATOL)
        np.testing.assert_allclose(tl.numpy()[:, 0], full[:, t], rtol=1e-5,
                                   atol=ATOL)
        ck[:, :, t] = tk.numpy()[:, :, 0]
        cv[:, :, t] = tv.numpy()[:, :, 0]


def test_decode_branch_chunk_against_jax():
    """A prefill chunk (several query tokens) over a partly filled
    context with pad slots, as the engine feeds it."""
    jm, jp, model, _ = lm()
    rng = np.random.default_rng(2)
    L, H, Dh = LAYERS, HEADS, D_MODEL // HEADS
    ck = rng.standard_normal((L, 1, 12, H, Dh)).astype(np.float32)
    cv = rng.standard_normal((L, 1, 12, H, Dh)).astype(np.float32)
    toks = rng.integers(0, VOCAB, (1, 4))
    pos = (5 + np.arange(4, dtype=np.int32))[None]
    jpos = jkv.context_positions(jnp.asarray([5]), 12)
    jl, (jk, jv) = jm.apply({"params": jp}, jnp.asarray(toks),
                            positions=jnp.asarray(pos),
                            kv_cache=(jnp.asarray(ck), jnp.asarray(cv), jpos))
    with torch.no_grad():
        tl, (tk, tv) = model(torch.from_numpy(toks),
                             positions=torch.from_numpy(pos),
                             kv_cache=(torch.from_numpy(ck),
                                       torch.from_numpy(cv),
                                       torch.from_numpy(np.array(jpos))))
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=ATOL)


@pytest.mark.parametrize("guard", ["sequence_axis", "causal", "positions"])
def test_decode_guards_raise_alike(guard):
    jm, jp, model, params = lm()
    jcfg = jm.cfg
    cache_j = (jnp.zeros((2, 1, 4, 4, 16)), jnp.zeros((2, 1, 4, 4, 16)),
               jnp.zeros((1, 4), jnp.int32))
    cache_t = tuple(torch.from_numpy(np.array(c)) for c in cache_j)
    pos = np.zeros((1, 1), np.int32)
    if guard == "positions":
        jmod, tmod, jpos, tpos = jm, model, None, None
    else:
        change = ({"sequence_axis": "seq"} if guard == "sequence_axis"
                  else {"causal": False})
        import dataclasses
        jmod = JTransformer(dataclasses.replace(jcfg, **change))
        tmod = Transformer(dataclasses.replace(model.cfg, **change))
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    with pytest.raises(ValueError) as je:
        jmod.apply({"params": jp}, jnp.zeros((1, 1), jnp.int32),
                   positions=jpos, kv_cache=cache_j)
    with pytest.raises(ValueError) as te:
        tmod(torch.zeros((1, 1), dtype=torch.long), positions=tpos,
             kv_cache=cache_t)
    assert str(te.value) == str(je.value)


def test_training_forward_is_unchanged_and_takes_no_positions():
    _, _, model, _ = lm()
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, VOCAB,
                                                              (2, 8)))
    with torch.no_grad():
        a = model(toks)
        b = model.forward(toks)
    assert torch.equal(a, b) and a.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="kv_cache"):
        model(toks, positions=torch.zeros((2, 8), dtype=torch.long))


# -- the KV pool ----------------------------------------------------------------

def _pool_case():
    rng = np.random.default_rng(0)
    kw = dict(num_blocks=6, block_size=4, num_layers=2, num_heads=2,
              head_dim=8, max_blocks_per_seq=3)
    jcfg = jkv.KVCacheConfig(dtype=jnp.float32, **kw)
    tcfg = tkv.KVCacheConfig(dtype=torch.float32, **kw)
    table = np.array([[1, 2, 0], [3, 5, 0]], np.int32)
    nk = rng.standard_normal((2, 2, 6, 2, 8)).astype(np.float32)
    nv = rng.standard_normal((2, 2, 6, 2, 8)).astype(np.float32)
    mask = np.array([[True] * 6, [True] * 3 + [False] * 3])
    start = np.array([0, 2], np.int32)
    return jcfg, tcfg, table, nk, nv, mask, start


def test_pool_functions_bit_for_bit():
    jcfg, tcfg, table, nk, nv, mask, start = _pool_case()
    assert tcfg.pool_bytes() == jcfg.pool_bytes()
    assert tcfg.max_context == jcfg.max_context
    assert [tcfg.blocks_for(n) for n in range(20)] == \
        [jcfg.blocks_for(n) for n in range(20)]
    assert tkv.PAD_POSITION == int(jkv.PAD_POSITION)
    jp = jkv.init_pool(jcfg)
    tp = tkv.init_pool(tcfg)
    jp = jkv.write_tokens(jp, jnp.asarray(table), jnp.asarray(start),
                          jnp.asarray(nk), jnp.asarray(nv),
                          mask=jnp.asarray(mask))
    tkv.write_tokens(tp, torch.from_numpy(table), torch.from_numpy(start),
                     torch.from_numpy(nk), torch.from_numpy(nv),
                     mask=torch.from_numpy(mask))
    # every block but the null block (masked writes land there, in an
    # order neither scatter defines) holds the same bits
    for key in ("k", "v"):
        np.testing.assert_array_equal(tp[key].numpy()[:, 1:],
                                      np.asarray(jp[key])[:, 1:])
    jg = jkv.gather_context(jp, jnp.asarray(table))
    tg = tkv.gather_context(tp, torch.from_numpy(table))
    valid = np.asarray(jkv.context_positions(jnp.asarray(start + 3),
                                             jcfg.max_context)) < 2 ** 30
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.numpy()[:, valid],
                                      np.asarray(b)[:, valid])
    # the layer-by-layer form is the same gather
    for layer in range(2):
        np.testing.assert_array_equal(
            tkv.LayerContext(tp["k"], torch.from_numpy(table))[layer].numpy(),
            tg[0][layer].numpy())
    jp = jkv.copy_block(jp, jnp.int32(2), jnp.int32(4))
    tkv.copy_block(tp, 2, 4)
    for key in ("k", "v"):
        np.testing.assert_array_equal(tp[key].numpy()[:, 1:],
                                      np.asarray(jp[key])[:, 1:])


@pytest.mark.parametrize("lengths", [[0, 3], [6, 12], [1, 11]])
def test_context_positions_bit_for_bit(lengths):
    j = jkv.context_positions(jnp.asarray(lengths, jnp.int32), 12)
    t = tkv.context_positions(torch.tensor(lengths, dtype=torch.int32), 12)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.dtype == torch.int32


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raise", str(e))


@pytest.mark.parametrize("seed", [123, 7])
def test_allocator_and_prefix_cache_fuzz_match_jax(seed):
    """One seeded sequence of alloc / retain / free (bad frees included)
    and prefix-cache insert / match / release / clear through both
    packages: the same results, the same raises, the same counts."""
    rng = np.random.default_rng(seed)
    sides = []
    for mod in (jkv, tkv):
        a = mod.BlockAllocator(33)
        sides.append((a, mod.PrefixCache(a, block_size=4)))
    held = []
    bank = [list(map(int, rng.integers(0, 6, int(rng.integers(3, 14)))))
            for _ in range(6)]
    for _ in range(1500):
        op = int(rng.integers(0, 8))
        if op == 0:
            n = int(rng.integers(0, 6))
            outs = [_outcome(lambda a=a: a.alloc(n)) for a, _ in sides]
            if outs[0][0] == "ok" and outs[0][1]:
                held.extend(outs[0][1])
        elif op == 1:
            b = int(rng.choice(held)) if held and rng.random() < .9 else 99
            outs = [_outcome(lambda a=a: a.retain([b])) for a, _ in sides]
            if outs[0][0] == "ok":
                held.append(b)
        elif op == 2:
            b = int(rng.choice(held)) if held and rng.random() < .9 else 77
            blocks = [b, b] if rng.random() < 0.2 else [b]
            outs = [_outcome(lambda a=a: a.free(blocks)) for a, _ in sides]
            if outs[0][0] == "ok":
                for x in blocks:
                    held.remove(x)
        elif op == 3 and held:
            toks = bank[int(rng.integers(0, len(bank)))]
            blocks = [int(rng.choice(held))
                      for _ in range(len(toks) // 4)]
            outs = [_outcome(lambda p=p: p.insert(toks, blocks))
                    for _, p in sides]
        elif op == 4:
            toks = bank[int(rng.integers(0, len(bank)))]
            outs = [_outcome(lambda p=p: p.match(toks)) for _, p in sides]
        elif op == 5:
            need = int(rng.integers(0, 34))
            outs = [_outcome(lambda p=p: p.release(need)) for _, p in sides]
        elif op == 6 and rng.random() < 0.05:
            outs = [_outcome(p.clear) for _, p in sides]
        else:
            outs = [_outcome(p.reclaimable) for _, p in sides]
        assert outs[0] == outs[1]
        (ja, jpc), (ta, tpc) = sides
        assert (ja.available, ja.in_use, jpc.size) == \
            (ta.available, ta.in_use, tpc.size)
        assert ja.available + ja.in_use == ja.capacity
        for b in range(33):
            assert ja.ref_count(b) == ta.ref_count(b)
            assert ja.is_shared(b) == ta.is_shared(b)


# -- sampling ----------------------------------------------------------------------

SEEDS = (0, 1, 2 ** 31, 2 ** 32 - 1)
INDICES = (0, 1, 5, 4095, 2 ** 31, 2 ** 32 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_bits_bit_for_bit(seed):
    seeds = torch.full((len(INDICES),), seed, dtype=torch.int64)
    k0 = tsampling.prng_key(seeds)
    key = tsampling.fold_in(k0, torch.tensor(INDICES, dtype=torch.int64))
    bits = tsampling.random_bits(key, 33)
    for i, idx in enumerate(INDICES):
        j0 = jax.random.PRNGKey(jnp.uint32(seed))
        np.testing.assert_array_equal(
            np.asarray(j0).astype(np.int64), [int(k0[0][i]), int(k0[1][i])])
        jk = jax.random.fold_in(j0, jnp.uint32(idx))
        np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                      [int(key[0][i]), int(key[1][i])])
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(jk, (33,), jnp.uint32)).astype(
                np.int64), bits[i].numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_draws_within_2_ulp(seed):
    """Within 2 ulp of JAX's draw, plus 2^-22: XLA's CPU ``log`` is one
    ulp off the correctly rounded value for ~15 % of inputs (torch's
    almost never), and ``-log(-log(u))`` carries a one-ulp difference of
    the inner log to 2^-22 where the draw is near 0."""
    seeds = torch.full((len(INDICES),), seed, dtype=torch.int64)
    key = tsampling.fold_in(tsampling.prng_key(seeds),
                            torch.tensor(INDICES, dtype=torch.int64))
    draws = tsampling.gumbel(key, 2000).numpy()
    tiny = float(jnp.finfo(jnp.float32).tiny)
    for i, idx in enumerate(INDICES):
        jk = jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)),
                                jnp.uint32(idx))
        want = np.asarray(jax.random.gumbel(jk, (2000,), jnp.float32))
        u = np.asarray(jax.random.uniform(jk, (2000,), jnp.float32,
                                          minval=tiny, maxval=1.0))
        got_u = tsampling.uniform_from_bits(
            tsampling.random_bits((key[0][i:i + 1], key[1][i:i + 1]), 2000),
            minval=tiny)[0].numpy()
        np.testing.assert_array_equal(got_u, u)
        bound = 2 * np.spacing(np.abs(want)) + 2.0 ** -22
        assert (np.abs(draws[i] - want) <= bound).all()


@pytest.mark.parametrize("case", ["mixed", "greedy", "top_p_small"])
def test_sample_tokens_same_ids_as_jax(case):
    rng = np.random.default_rng({"mixed": 0, "greedy": 1,
                                 "top_p_small": 2}[case])
    logits = rng.standard_normal((8, VOCAB)).astype(np.float32) * 3
    seeds = np.array([7, 7, 8, 2 ** 31, 0, 1, 99, 2 ** 32 - 1], np.uint32)
    indices = np.array([6, 7, 6, 1, 0, 12, 300, 5], np.int32)
    temps = {"mixed": [0.9, 0.9, 0.9, 0, 0.5, 1.5, 0, 0.8],
             "greedy": [0] * 8,
             "top_p_small": [0.9] * 8}[case]
    top_ps = {"mixed": [0.8, 0.8, 0.8, 0.7, 1.0, 0.3, 1.0, 0.95],
              "greedy": [0.7] * 8, "top_p_small": [0.05] * 8}[case]
    temps = np.array(temps, np.float32)
    top_ps = np.array(top_ps, np.float32)
    want = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(indices),
        jnp.asarray(temps), jnp.asarray(top_ps)))
    got = tsampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(indices), torch.from_numpy(temps),
        torch.from_numpy(top_ps))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    if case == "greedy":
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def test_sampling_params_validate_alike():
    for kw in ({"temperature": -0.5}, {"top_p": 0}, {"top_p": 1.5},
               {"seed": "lucky"}):
        with pytest.raises(ValueError) as je:
            jsampling.SamplingParams(**kw)
        with pytest.raises(ValueError) as te:
            tsampling.SamplingParams(**kw)
        assert str(te.value) == str(je.value)
    assert tsampling.GREEDY == tsampling.SamplingParams()


# -- the engine: streams --------------------------------------------------------

def _both(fn):
    """``fn(side)`` on each package: ``(jax result, port result)``."""
    return fn(JAX), fn(PORT)


def test_engine_midflight_joins_match_jax_and_oracle():
    p1, p2, p3 = prompts(2, (5, 9, 2))

    def run(side):
        eng = make_engine(side)
        r1 = eng.generate(p1, 8)
        for _ in range(4):
            eng.step()
        assert r1.state == "decode"
        r2, r3 = eng.generate(p2, 8), eng.generate(p3, 8)
        run_until(eng, [r1, r2, r3])
        for r in (r1, r2, r3):
            assert r.result(timeout=5) == r.generated
            assert r.finish_reason == "length"
        assert_no_leak(eng)
        return [r.generated for r in (r1, r2, r3)]

    j, t = _both(run)
    assert t == j
    assert t == [oracle(p, 8) for p in (p1, p2, p3)]


def test_engine_eos_stops_early():
    p, = prompts(4, (6,))
    first = oracle(p, 1)[0]

    def run(side):
        eng = make_engine(side, max_slots=2)
        r = eng.generate(p, 50, eos_id=first)
        run_until(eng, [r])
        assert_no_leak(eng)
        return r.generated, r.finish_reason

    j, t = _both(run)
    assert t == j == ([first], "eos")


def test_engine_prefix_cache_hits_and_cow_match_jax():
    system, = prompts(21, (9,))
    p, = prompts(22, (8,))

    def run(side):
        eng = make_engine(side)
        out = []
        for prompt in (system + [5], system + [7, 8], p, p, p):
            r = eng.generate(prompt, 6)
            run_until(eng, [r])
            out.append((r.generated, r.cached_prompt_tokens))
        out.append((eng.cached_prefill_tokens, eng.prompt_tokens,
                     eng.instruments.cached_prefill_tokens.value))
        assert_no_leak(eng)
        return out

    j, t = _both(run)
    assert t == j
    assert [c for _, c in t[:5]] == [0, 8, 0, 7, 7]
    assert [g for g, _ in t[:5]] == [oracle(q, 6) for q in (
        system + [5], system + [7, 8], p, p, p)]


def test_engine_forks_once_per_cow_admission():
    p, = prompts(22, (8,))
    eng = make_engine(PORT)
    for _ in range(3):
        r = eng.generate(p, 3)
        run_until(eng, [r])
    assert eng.dispatches["fork"] == 2
    assert eng.dispatches["prefill"] == 2 + 1 + 1


def test_seeded_sampling_matches_jax_across_replicas_reload_and_hops():
    """The JAX test's contract, on both packages, with equal streams:
    same (seed, prompt) on two engines, across a mid-flight reload of
    the same values and across a continuation hop."""
    p, = prompts(32, (6,))

    def run(side):
        sp = side.sampling.SamplingParams(temperature=0.9, top_p=0.8, seed=7)
        e1, e2 = make_engine(side, max_slots=2), make_engine(side, max_slots=2)
        r1 = e1.generate(p, 12, sampling=sp)
        run_until(e1, [r1])
        r2 = e2.generate(p, 12, sampling=sp)
        run_until(e2, [r2])
        assert r1.generated == r2.generated
        r3 = e1.generate(p, 12, sampling=side.sampling.SamplingParams(
            temperature=0.9, top_p=0.8, seed=8))
        run_until(e1, [r3])
        assert r3.generated != r1.generated
        e3 = make_engine(side, max_slots=2)
        r4 = e3.generate(p, 12, sampling=sp)
        while len(r4.generated) < 6:
            e3.step()
        _, jp, _, params = lm()
        e3.install_weights(params if side.port else jp, version=9)
        run_until(e3, [r4])
        assert e3.weights_version == 9 and r4.generated == r1.generated
        r5 = e1.generate(p + r1.generated[:5], 7, sampling=sp)
        run_until(e1, [r5])
        assert r5.generated == r1.generated[5:]
        greedy = e1.generate(p, 10, sampling=side.sampling.SamplingParams(
            temperature=0.0, top_p=0.7, seed=99))
        run_until(e1, [greedy])
        return r1.generated, r3.generated, greedy.generated

    j, t = _both(run)
    assert t == j
    assert t[2] == oracle(p, 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sampled", [False, True])
def test_replay_continues_the_unbroken_stream_bit_for_bit(dtype, sampled):
    """A continuation whose generated tokens replay through decode gives
    the unbroken stream's later tokens exactly, and writes the same pool
    bits for them, in bf16 as in fp32."""
    p, other = prompts(40, (7, 5))
    sp = tsampling.SamplingParams(temperature=0.8, top_p=0.9, seed=3) \
        if sampled else None
    ref = make_engine(PORT, dtype=dtype)
    busy = ref.generate(other, 20)
    r = ref.generate(p, 16, sampling=sp)
    run_until(ref, [r, busy])
    for k in (1, 5, 15):
        eng = make_engine(PORT, dtype=dtype)
        noise = eng.generate(other[::-1], 9)
        cont = eng.submit(tengine.Request(p + r.generated[:k], 16 - k,
                                          sampling=sp, replay=k))
        run_until(eng, [cont, noise])
        assert cont.generated == r.generated[k:], k
        assert eng.prompt_tokens == len(p) + k + len(other)
    with pytest.raises(tengine.RequestError, match="replay"):
        make_engine(PORT).submit(tengine.Request([1, 2], 3, replay=2))


def test_engine_takes_a_flax_tree_or_a_state_dict():
    jm, jp, model, params = lm()
    kv = kv_config(PORT)
    a = tengine.ServeEngine(model, jp, kv, device=DEV, prefill_chunk=4,
                            registry=treg.MetricsRegistry())
    b = tengine.ServeEngine(model, params, kv, device=DEV, prefill_chunk=4,
                            registry=treg.MetricsRegistry())
    for name, t in b._params.items():
        assert torch.equal(a._params[name], t)
    p, = prompts(5, (5,))
    ra, rb = a.generate(p, 4), b.generate(p, 4)
    run_until(a, [ra])
    run_until(b, [rb])
    assert ra.generated == rb.generated == oracle(p, 4)


def test_engine_device_rules(monkeypatch):
    _, _, model, params = lm()
    kv = kv_config(PORT)
    wide = mesh_lib.Mesh(group=None, device=DEV, size=2, rank=0)
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        tengine.ServeEngine(model, params, kv, mesh=wide)
    one = mesh_lib.Mesh(group=None, device=DEV, size=1, rank=0)
    assert tengine.ServeEngine(model, params, kv, mesh=one).device == DEV

    def uninitialized():
        raise RuntimeError("not initialized")

    monkeypatch.setattr(mesh_lib, "get_mesh", uninitialized)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.ServeEngine(model, params, kv)


# -- the engine: the scheduler on a fake clock ------------------------------

class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _state(eng, reqs):
    return (tuple((r.state, len(r.generated), r.prefilled,
                   r.cached_prompt_tokens, r.slot, r.finish_reason)
                  for r in reqs),
            eng.queue_depth, eng.active_count, eng.allocator.in_use,
            eng.allocator.available,
            eng.prefix_cache.size if eng.prefix_cache is not None else 0,
            eng.instruments.queue_depth.value, eng.instruments.kv_blocks.value)


def _scenario(side, name):
    """Run scenario ``name`` on ``side`` under a fake clock; returns the
    per-iteration log (stats, every request's state, the pool's counts),
    the streams and the time attribution."""
    clk = Clock()
    R = side.engine.Request
    engine_kw = {
        "fifo": dict(max_slots=1),
        "preempt": dict(max_slots=2),
        "alongside": dict(max_slots=2),
        "backpressure": dict(kv=dict(num_blocks=5, mbps=4)),
        "cache_pressure": dict(max_slots=1, kv=dict(num_blocks=9, mbps=8)),
        "pinned_match": dict(max_slots=2, kv=dict(num_blocks=10, mbps=8)),
        "mixed": dict(max_slots=3),
    }[name]
    eng = make_engine(side, clock=clk, **engine_kw)
    reqs, log = [], []

    def submit(tokens, n, **kw):
        r = eng.submit(R(tokens, n, request_id=len(reqs), **kw))
        reqs.append(r)
        return r

    def step():
        stats = eng.step()
        clk.t += 0.01
        log.append((dict(stats), _state(eng, reqs)))

    ps = prompts(5, (4, 4, 4, 12, 3, 26, 8, 9, 17))
    if name == "fifo":
        for p in ps[:3]:
            submit(p, 3)
            clk.t += 1.0
    elif name == "preempt":
        submit(ps[3], 2)
        clk.t += 1.0
        submit(ps[4], 2)
    elif name == "alongside":
        submit(ps[0], 30)
        for _ in range(3):
            step()
        submit(ps[3], 2)
    elif name == "backpressure":
        submit(ps[0], 8)
        submit(ps[1], 8)
    elif name == "cache_pressure":
        submit(ps[6], 4)
        for _ in range(12):
            step()
        submit(ps[5], 4)
    elif name == "pinned_match":
        p1 = list(range(8))
        submit(p1, 4)
        for _ in range(12):
            step()
        submit([9] * 8, 8)
        submit(p1 + list(range(16, 25)), 4)
    elif name == "mixed":
        sp = side.sampling.SamplingParams(temperature=0.7, top_p=0.9, seed=5)
        submit(ps[7], 6, sampling=sp)
        step()
        submit(ps[7][:8] + [3], 5)
        submit(ps[2], 40, eos_id=oracle(ps[2], 3)[2])
        step()
        submit(ps[8], 4)
    for _ in range(300):
        if all(r.state in ("done", "failed") for r in reqs):
            break
        step()
    assert all(r.state == "done" for r in reqs)
    return log, [r.generated for r in reqs], dict(eng.time_breakdown)


SCENARIOS = ["fifo", "preempt", "alongside", "backpressure",
             "cache_pressure", "pinned_match", "mixed"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scheduler_log_matches_jax_on_a_fake_clock(name):
    """Admission order, prefill preemption, prefill beside decode, KV
    backpressure and eviction, prefix-cache pressure, the pinned match,
    EOS and sampling: each iteration's stats, every request's state and
    the pool's counts equal the JAX engine's, and so do the streams."""
    j, t = _both(lambda side: _scenario(side, name))
    assert len(t[0]) == len(j[0])
    for i, (a, b) in enumerate(zip(t[0], j[0])):
        assert a == b, f"iteration {i}: port {a} jax {b}"
    assert t[1] == j[1]
    assert t[2] == pytest.approx(j[2])


def test_scheduler_scenarios_hold_their_claims():
    """What the scenarios show, on the port: FIFO finishing order, the
    longest-waiting prefill first, prefill beside decode, backpressure,
    the cache giving blocks up, the pinned match never duplicated."""
    log, _, _ = _scenario(PORT, "fifo")
    done = []
    for _, (states, *_) in log:
        for i, s in enumerate(states):
            if s[0] == "done" and i not in done:
                done.append(i)
    assert done == [0, 1, 2]
    log, _, _ = _scenario(PORT, "preempt")
    seq = [s["prefilled"] for s, _ in log if "prefilled" in s]
    assert seq[:4] == [0, 0, 0, 1]
    log, _, _ = _scenario(PORT, "alongside")
    first = next(s for s, (st, *_) in log
                 if len(st) == 2 and st[1][0] != "queued")
    assert first.get("prefilled") == 1 and first.get("decoded") == 1
    log, streams, _ = _scenario(PORT, "backpressure")
    assert log[0][1][0][1][0] == "queued" and log[0][1][1] == 1
    assert streams[1] == oracle(prompts(5, (4, 4))[1], 8)


def test_submit_rejects_unsatisfiable_reservation():
    def run(side):
        eng = make_engine(side, max_slots=1, kv=dict(num_blocks=5, mbps=4))
        req = side.engine.Request([1, 2, 3], 1000)
        with pytest.raises(side.engine.RequestError) as e:
            eng.submit(req)
        with pytest.raises(side.engine.RequestError):
            req.result(timeout=1)
        empty = side.engine.Request([], 3)
        with pytest.raises(side.engine.RequestError):
            eng.submit(empty)
        return str(e.value), req.state, eng.instruments.failed.value

    j, t = _both(run)
    assert t == j and t[1] == "failed" and t[2] == 2


def test_serve_metrics_render_as_jax():
    """The same two requests on each package, into fresh registries:
    the same hvd_serve_* counters and histogram counts."""
    ps = prompts(9, (4, 4))

    def run(side):
        reg = side.registry.MetricsRegistry()
        eng = make_engine(side, max_slots=2, registry=reg)
        reqs = [eng.generate(p, 5) for p in ps]
        run_until(eng, reqs)
        ins = eng.instruments
        return (ins.submitted.value, ins.completed.value, ins.tokens.value,
                ins.ttft_seconds.count, ins.inter_token_seconds.count,
                sorted(ln for ln in reg.render_prometheus().splitlines()
                       if ln.startswith("# ") or "_count" in ln
                       or "_total" in ln))

    j, t = _both(run)
    assert t == j
    assert t[:5] == (2, 2, 10, 2, 8)


def test_time_breakdown_tiles_a_stepped_run():
    """Driven by ``step()`` on the host clock: prefill + decode +
    overhead is the wall of the steps, to the clock's resolution."""
    eng = make_engine(PORT)
    reqs = [eng.generate(p, 6) for p in prompts(11, (5, 9, 3))]
    t0 = time.monotonic()
    run_until(eng, reqs)
    wall = time.monotonic() - t0
    parts = eng.time_breakdown
    assert parts["idle"] == 0.0
    assert sum(parts.values()) == pytest.approx(wall, rel=0.02, abs=2e-3)
    assert parts["prefill"] > 0 and parts["decode"] > 0


# -- the loader -------------------------------------------------------------------

def _save_world(root, step, tree, world, meta=None):
    """All ``world`` ranks of one JAX save in-process, then the commit."""
    zi = None
    for r in range(world):
        payload, zi = jckpt.snapshot_tree(tree, r, world)
        jsharded.write_shard(root, step, payload)
    return jmanifest.commit(root, step, 0, world, meta=meta, zero_info=zi,
                            keep=None)


def _train_state(params, opt, step):
    return TrainState(params=params, opt_state=opt.init(params),
                      batch_stats={}, step=jnp.asarray(step, jnp.int32))


def _leaves_equal(got, want):
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("world", [1, 4])
def test_load_params_of_a_jax_manifest_bit_for_bit(tmp_path, world):
    """A ZeRO-sharded JAX TrainState checkpoint from an N-rank world:
    params only, bit for bit the JAX loader's (and the trained params),
    the rows never read."""
    jm, jp, model, _ = lm()
    leaves = jax.tree_util.tree_leaves(jp)
    sched = jfusion.bucket_schedule(leaves, world, threshold_bytes=4096,
                                    axes=("data",))
    zstate = jzero.init(optax.adam(1e-2), jp, jzero.ZeroPlan(schedule=sched))
    state = TrainState(params=jp, opt_state=zstate, batch_stats={},
                       step=jnp.asarray(5, jnp.int32))
    _save_world(str(tmp_path), 5, state, world,
                meta={"model_config": {"d_model": D_MODEL}})
    step, got, meta = tloader.load_params(str(tmp_path),
                                          tloader.abstract_params(model))
    jstep, want, jmeta = jloader.load_params(str(tmp_path),
                                             jloader.abstract_params(jm))
    assert (step, meta) == (jstep, jmeta) == (5, {"model_config": {
        "d_model": D_MODEL}})
    _leaves_equal(got, want)
    _leaves_equal(got, jp)
    sd = convert.params_from_flax(got, model)
    for name, t in model.state_dict().items():
        assert torch.equal(sd[name], t)


def test_load_params_of_a_port_checkpoint(tmp_path):
    """A state the port saves (``convert.train_state_to_flat`` with AdamW
    through ``ckpt.save_sharded``) loads params-only in both packages."""
    import horovod_tpu_torch as hvd_t
    from horovod_tpu_torch import hvd_torch, training
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        jm, jp, model, _ = lm()
        m = Transformer(model.cfg)
        m.load_state_dict(model.state_dict())
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.AdamW(m.parameters(), lr=1e-3),
            named_parameters=convert.flax_named_parameters(m))
        training.create_train_state(m, opt)
        step = training.make_lm_train_step(m, opt)
        step(torch.from_numpy(np.random.default_rng(0).integers(
            0, VOCAB, (2, 9))))
        ckpt.save_sharded(str(tmp_path), 1, convert.train_state_to_flat(
            m, opt, step.state))
        _, got, _ = tloader.load_params(str(tmp_path),
                                        tloader.abstract_params(model))
        _, want, _ = jloader.load_params(str(tmp_path),
                                         jloader.abstract_params(jm))
        _leaves_equal(got, want)
        _leaves_equal(got, convert.flax_from_params(m.state_dict(), m))
    finally:
        hvd_t.shutdown()


def test_load_params_shape_mismatch_is_loud(tmp_path):
    _, jp, _, _ = lm()
    _save_world(str(tmp_path), 0, _train_state(jp, optax.sgd(0.1), 0), 2)
    wrong = Transformer(TransformerConfig(vocab_size=VOCAB, num_layers=2,
                                          num_heads=3, d_model=48, d_ff=192))
    with pytest.raises(ValueError, match="wrong model config"):
        tloader.load_params(str(tmp_path), tloader.abstract_params(wrong))
    with pytest.raises(FileNotFoundError):
        tloader.load_params(str(tmp_path / "none"),
                            tloader.abstract_params(wrong))


def test_load_params_falls_back_past_corrupt_newest(tmp_path):
    jm, jp, model, _ = lm()
    root = str(tmp_path)
    bumped = jax.tree_util.tree_map(lambda x: x + 1, jp)
    _save_world(root, 1, _train_state(jp, optax.sgd(0.1), 1), 2)
    _save_world(root, 2, _train_state(bumped, optax.sgd(0.1), 2), 2)
    path = jsharded.shard_path(root, 2, 0, 2)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    target = tloader.abstract_params(model)
    step, got, _ = tloader.load_params(root, target)
    assert step == 1
    _leaves_equal(got, jp)
    with pytest.raises(sharded.ShardValidationError):
        tloader.load_params(root, target, step=2)
    with pytest.raises(FileNotFoundError, match="MANIFEST"):
        tloader.load_params(root, target, step=7)


def test_manifest_probes_match_jax(tmp_path):
    root = str(tmp_path)
    _, jp, _, _ = lm()
    assert manifest.latest_manifest(root) is None
    state = _train_state(jp, optax.sgd(0.1), 1)
    _save_world(root, 1, state, 1)
    _save_world(root, 3, state, 1)
    payload, _ = jckpt.snapshot_tree(state, 0, 1)
    jsharded.write_shard(root, 7, payload)  # torn: no manifest
    assert manifest.complete_manifests(root) == \
        jmanifest.complete_manifests(root)
    assert manifest.latest_manifest(root) == jmanifest.latest_manifest(root)
    assert manifest.manifest_mtime(root, 7) is None
    assert manifest.manifest_path(root, 3) == jmanifest.manifest_path(root, 3)


class _FakeEngine:
    def __init__(self):
        self.installed = []

    def install_weights(self, params, version=None):
        self.installed.append(version)


def test_reload_watcher_poll_cycle_matches_jax(tmp_path):
    """Both watchers over one root through the JAX test's script: the
    same answers at every poll, the same installs."""
    jm, jp, model, _ = lm()
    root = str(tmp_path)
    state = _train_state(jp, optax.sgd(0.1), 1)
    _save_world(root, 1, state, 1)
    engines = (_FakeEngine(), _FakeEngine())
    watchers = (jloader.ReloadWatcher(root, engines[0],
                                      jloader.abstract_params(jm)),
                tloader.ReloadWatcher(root, engines[1],
                                      tloader.abstract_params(model)))
    for w in watchers:
        w.mark_current(1)

    def poll():
        got = [w.poll_once() for w in watchers]
        assert got[0] == got[1]
        return got[1]

    assert poll() is None
    payload, _ = jckpt.snapshot_tree(state, 0, 1)
    jsharded.write_shard(root, 9, payload)
    assert poll() is None
    _save_world(root, 2, state, 1)
    assert poll() == 2
    assert poll() is None
    time.sleep(0.05)
    jmanifest.clear_stale_ack(root, 2, 0, 1)
    _save_world(root, 2, state, 1)
    assert poll() == 2
    # the damaged highest step: remembered, not retried; a fresh LOWER
    # step number rolls in by commit time
    time.sleep(0.02)
    _save_world(root, 10, state, 1)
    path = jsharded.shard_path(root, 10, 0, 1)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    assert poll() is None and poll() is None
    time.sleep(0.02)
    _save_world(root, 6, state, 1)
    assert poll() == 6
    assert engines[0].installed == engines[1].installed == [2, 2, 6]


def test_reload_watcher_rolls_weights_into_a_live_engine(tmp_path):
    """The watcher's thread stages a newer checkpoint into an engine
    serving a stream; the stream finishes under the new weights."""
    jm, jp, model, params = lm()
    root = str(tmp_path)
    _save_world(root, 1, _train_state(jp, optax.sgd(0.1), 1), 1)
    eng = make_engine(PORT, kv=dict(num_blocks=128, mbps=64),
                      weights_version=1)
    watcher = tloader.ReloadWatcher(root, eng, tloader.abstract_params(model),
                                    poll_s=0.02)
    watcher.mark_current(1)
    watcher.start()
    try:
        p, = prompts(12, (3,))
        r = eng.generate(p, 200)
        for _ in range(3):
            eng.step()
        _save_world(root, 3, _train_state(jax.tree_util.tree_map(
            lambda x: x * 1.01, jp), optax.sgd(0.1), 3), 1)
        deadline = time.time() + 30
        while eng.weights_version != 3 and time.time() < deadline:
            eng.step()
            time.sleep(0.005)
        assert eng.weights_version == 3
        assert r.state != "done"  # swapped under a live request
        run_until(eng, [r], max_steps=400)
        assert len(r.generated) == 200 and eng.instruments.failed.value == 0
    finally:
        watcher.stop()


# -- HTTP ----------------------------------------------------------------------------

def http_generate(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return [json.loads(line) for line in resp]


def test_http_streams_the_jax_servers_tokens():
    """The same greedy and seeded requests through each package's
    ``ServeServer``: the same ndjson lines, and ``/metrics`` counts what
    was served."""
    p, = prompts(13, (7,))
    bodies = [{"tokens": p, "max_new_tokens": 6},
              {"tokens": p, "max_new_tokens": 6, "temperature": 0.9,
               "top_p": 0.8, "seed": 11}]

    def run(side):
        eng = make_engine(side)
        srv = (tserver if side.port else jserver).ServeServer(eng, port=0)
        port = srv.start()
        eng.start()
        try:
            lines = [http_generate(port, b) for b in bodies]
            scrape = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
            health = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10).read())
        finally:
            srv.stop()
            eng.stop()
        counts = [ln for ln in scrape.splitlines()
                  if ln.startswith(("hvd_serve_tokens_total",
                                    "hvd_serve_requests_total"))]
        return lines, counts, health

    j, t = _both(run)
    assert t == j
    lines, counts, health = t
    assert [ln["token"] for ln in lines[0][:-1]] == oracle(p, 6)
    assert lines[0][-1] == {"done": True, "tokens": oracle(p, 6),
                            "finish_reason": "length"}
    assert "hvd_serve_tokens_total 12" in counts
    assert 'hvd_serve_requests_total{event="completed"} 2' in counts
    assert health["status"] == "ok"


BAD_BODIES = [b"{}", b'{"tokens": "nope"}', b'{"tokens": [1], "eos_id": "x"}',
              b'{"tokens": [1], "max_new_tokens": "many"}',
              b'{"tokens": [1], "temperature": -0.5}',
              b'{"tokens": [1], "top_p": 0}',
              b'{"tokens": [1], "seed": "lucky"}',
              json.dumps({"tokens": [1], "max_new_tokens": 10 ** 6}).encode(),
              b"not json"]


def test_http_bad_requests_get_400_and_draining_is_503():
    eng = make_engine(PORT, max_slots=1)
    srv = tserver.ServeServer(eng, port=0)
    port = srv.start()
    eng.start()
    try:
        for body in BAD_BODIES:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=body)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=10)
            assert e.value.code == 400, body
        eng.set_draining(True)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=10)
        assert e.value.code == 503
        assert json.loads(e.value.read())["status"] == "draining"
        with pytest.raises(tengine.RequestError, match="draining"):
            eng.submit(tengine.Request([1, 2], 2))
        eng.set_draining(False)
        assert eng.generate([1, 2], 2).result(timeout=60)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nothing",
                                   timeout=10)
        assert e.value.code == 404
    finally:
        srv.stop()
        eng.stop()
    with pytest.raises(tengine.RequestError, match="stopped"):
        eng.generate([1, 2], 2)


# -- the CLI ------------------------------------------------------------------------

def test_cli_parser_meta_check_and_devices():
    from horovod_tpu.serve import cli as jcli
    from horovod_tpu_torch.serve import cli
    argv = ["--ckpt-dir", "/tmp/x", "--num-layers", "2", "--d-model", "32",
            "--num-heads", "2", "--d-ff", "64"]
    args = cli.build_parser().parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    assert {k: v for k, v in vars(args).items() if k != "device"} == \
        vars(jargs)
    assert args.device == "cuda"
    cli._check_meta({"model_config": {"d_model": 32}}, args)
    cli._check_meta({}, args)
    with pytest.raises(SystemExit, match="mismatched architecture"):
        cli._check_meta({"model_config": {"d_model": 512}}, args)
    assert cli.replica_devices(3, "cpu") == [DEV] * 3


def test_cli_serves_a_checkpoint_over_http(tmp_path):
    """``hvd-serve-torch --device cpu`` in a subprocess on a JAX-written
    checkpoint: one streamed request equals the oracle; SIGTERM stops it
    with exit 0."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    _, jp, _, _ = lm()
    _save_world(str(tmp_path), 4, _train_state(jp, optax.sgd(0.1), 4), 2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve.cli", "--ckpt-dir",
         str(tmp_path), "--port", str(port), "--device", "cpu",
         "--vocab-size", str(VOCAB), "--num-layers", str(LAYERS),
         "--num-heads", str(HEADS), "--d-model", str(D_MODEL),
         "--d-ff", str(D_FF), "--dtype", "float32", "--max-slots", "2",
         "--prefill-chunk", "4", "--max-seq-len", "64", "--no-reload"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        p, = prompts(14, (5,))
        deadline = time.time() + 60
        while True:
            try:
                lines = http_generate(port, {"tokens": p,
                                             "max_new_tokens": 4})
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.time() < deadline
                time.sleep(0.2)
        assert lines[-1]["tokens"] == oracle(p, 4)
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out.decode()[-2000:]
