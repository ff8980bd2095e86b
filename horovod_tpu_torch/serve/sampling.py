"""Sampling for the serving plane: temperature / top-p / seeds. The port
of ``horovod_tpu/serve/sampling.py``, draw for draw.

Greedy argmax stays the default (deterministic: the engine's
"continuous batching equals single-shot" contract is built on it). The
stochastic lanes keep that determinism:

* **Per-request seeds.** Every sampled token's randomness comes from
  ``fold_in(PRNGKey(seed), token_index)`` where ``token_index`` is the
  token's ABSOLUTE position in the sequence. The key depends only on
  (seed, position) — not on batch composition, not on which replica runs
  the request, not on how the prompt was chunked — so the same seed and
  prompt give the same stream on any replica, across a weight reload of
  the same values, and across a fleet re-dispatch.
* **JAX's keys and draws.** The keys are JAX's own: threefry-2x32 (JAX's
  default PRNG, with ``jax_threefry_partitionable``) is integer
  arithmetic on 32-bit words, written here on int64 tensors masked to 32
  bits (torch's uint32 arithmetic is thin). :func:`prng_key`,
  :func:`fold_in` and :func:`random_bits` give ``jax.random``'s words bit
  for bit, and :func:`gumbel` maps them to floats as ``jax.random.gumbel``
  does (its default "low" mode). Only ``log`` differs: XLA's CPU ``log``
  is one ulp off the correctly rounded value for about 15 % of inputs,
  torch's almost never, so a draw can differ by that ulp carried through
  ``-log(-log(u))`` (2^-22 at most); a token differs only where two
  candidates tie that closely.
* **Bitwise-greedy at temperature 0.** ``temperature <= 0`` selects the
  plain ``argmax`` lane — the identical integer — so deterministic
  requests keep matching the greedy oracle while sharing the batch with
  sampled ones.

Top-p (nucleus) filtering keeps the smallest logit-ranked set whose
probability mass reaches ``top_p`` (always at least the top token), then
draws via Gumbel-max over the surviving logits.
"""

import dataclasses

import torch

_MASK = 0xFFFFFFFF
# threefry-2x32's rotations, its key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_FLOAT32_TINY = 1.1754943508222875e-38  # jnp.finfo(float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. The default is greedy decoding
    (``temperature=0``); ``seed`` only matters once
    ``temperature > 0``."""

    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0 < self.top_p <= 1:
            raise ValueError("top_p must be in (0, 1]")
        int(self.seed)  # must be integral


GREEDY = SamplingParams()


def _rotl(x, d):
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash of JAX's ``threefry2x32_p``: keys and
    counts are int64 tensors holding uint32 words (broadcast together);
    returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def prng_key(seed):
    """``jax.random.PRNGKey(seed)`` of uint32 seeds: the words
    ``(seed >> 32, seed & 0xFFFFFFFF)``, which for a 32-bit seed is
    ``(0, seed)``. ``seed`` an int64 tensor of uint32 values."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & _MASK
    return torch.zeros_like(seed), seed


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: threefry of the counts
    ``(0, data)`` under ``key``. ``data`` an int64 tensor of uint32
    values, broadcast against the key's words."""
    k1, k2 = key
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=k1.device) & _MASK
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def random_bits(key, n):
    """``jax.random.bits(key, (n,), uint32)`` under the partitionable
    threefry: each word hashes its flat index (high word 0, low word the
    index) and the two outputs are xored. ``key``'s words of shape
    ``[B]`` give ``[B, n]``."""
    k1, k2 = (w[..., None] for w in key)
    counts = torch.arange(n, dtype=torch.int64, device=k1.device)
    bits1, bits2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return bits1 ^ bits2


def uniform_from_bits(bits, minval=0.0):
    """``jax.random.uniform``'s float32 map: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, scaled to
    ``[minval, 1)`` and clamped below at ``minval``."""
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    return torch.clamp_min(floats * (1.0 - minval) + minval, minval)


def gumbel(key, n):
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low"):
    ``-log(-log(u))`` of uniforms on ``[tiny, 1)``."""
    u = uniform_from_bits(random_bits(key, n), minval=_FLOAT32_TINY)
    return -torch.log(-torch.log(u))


def greedy_tokens(logits):
    """``[B, V]`` logits -> ``[B]`` int32 argmax (the first of ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(logits, seeds, indices, temperature, top_p):
    """Batched per-slot next-token selection: ``[B, V]`` logits ->
    ``[B]`` int32 token ids.

    ``seeds``/``indices``/``temperature``/``top_p`` are ``[B]``
    tensors; ``indices[i]`` is the ABSOLUTE index of the token being
    sampled for slot ``i`` (len(prompt) + generated so far) — the
    fold-in that makes streams position-deterministic (module
    docstring). Slots with ``temperature <= 0`` take the bitwise argmax
    lane."""
    greedy = greedy_tokens(logits)
    # the zero-temperature lane's scaled logits are discarded by the
    # final where; guard the division so they are merely unused, not NaN
    temperature = temperature.float()
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logits.float() / safe_t[:, None]
    # nucleus cutoff in sorted space: keep while the mass BEFORE a
    # token is < top_p (the top token's "before" mass is 0 — always in)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    e = torch.exp(sorted_desc - sorted_desc[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep = mass_before < top_p.float()[:, None]
    cutoff = torch.where(keep, sorted_desc, torch.full_like(
        sorted_desc, float("inf"))).min(dim=-1, keepdim=True).values
    nucleus = torch.where(scaled >= cutoff, scaled,
                          torch.full_like(scaled, float("-inf")))
    key = fold_in(prng_key(seeds.to(logits.device)),
                  indices.to(logits.device))
    sampled = greedy_tokens(nucleus + gumbel(key, logits.shape[-1]))
    return torch.where(temperature > 0, sampled, greedy)
