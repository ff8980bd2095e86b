"""The port's data plane (horovod_tpu_torch/data) against the JAX
package's (horovod_tpu/data), on the same numpy inputs: the index
streams of ``shard_indices``, ``DistributedSampler`` and
``local_batches``, the batches of ``ArraySource`` and ``FileSource``, and
the ``PrefetchLoader`` stream, whole and after ``set_cursor`` (the
cursors of either package resume the other's stream), across epoch
boundaries, with shuffle and ``drop_last``, at world 1 and 2, and after
an elastic ``on_reset``. Everything is index arithmetic on numpy's
``default_rng((seed, epoch))``, so the streams are equal exactly.

``make_train_step(loader=...)`` on the CPU: ``step()`` pulls the
loader's batches and gives the losses of the same batches passed by
hand, bit for bit.
"""

import itertools

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu import data as jdata
from horovod_tpu_torch import data as tdata
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models.simple import MLP


def _arrays(n=23):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            rng.integers(0, 3, size=(n,)).astype(np.int64))


@pytest.mark.parametrize("n,shards,shuffle,drop_last", [
    (23, 1, True, False), (23, 2, True, False), (23, 3, False, True),
    (24, 4, True, True), (5, 8, True, False)])
def test_index_streams_match_jax(n, shards, shuffle, drop_last):
    for epoch, rank in itertools.product((0, 1, 7), range(shards)):
        kw = dict(epoch=epoch, shuffle=shuffle, seed=11,
                  drop_last=drop_last)
        np.testing.assert_array_equal(
            tdata.shard_indices(n, shards, rank, **kw),
            jdata.shard_indices(n, shards, rank, **kw))
        samplers = [mod.DistributedSampler(n, shards, rank, shuffle=shuffle,
                                           seed=11, drop_last=drop_last)
                    for mod in (tdata, jdata)]
        for s in samplers:
            s.set_epoch(epoch)
        assert list(samplers[0]) == list(samplers[1])
        assert len(samplers[0]) == len(samplers[1])
    x, y = _arrays(n)
    for ours, theirs in zip(
            tdata.local_batches((x, y), 3, shards, 0, seed=2,
                                drop_last=drop_last),
            jdata.local_batches((x, y), 3, shards, 0, seed=2,
                                drop_last=drop_last)):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_sharding_needs_a_rank_when_not_initialized():
    hvd_t.shutdown()
    with pytest.raises(ValueError, match="shard_id"):
        tdata.shard_indices(10, 2)
    with pytest.raises(ValueError, match="not in"):
        tdata.shard_indices(10, 2, 5)


def _stream(loader, n):
    out = []
    for _ in range(n):
        out.append(tuple(np.asarray(a) for a in next(loader)))
    return out


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, True)])
def test_loader_stream_and_cursor_resume_match_jax(world, shuffle,
                                                   drop_last):
    """Every rank's stream over 3 epochs equals the JAX loader's; a
    loader of either package set to the other's cursor mid-epoch (and at
    an epoch boundary) replays the rest of the same stream."""
    x, y = _arrays()
    kw = dict(seed=5, shuffle=shuffle, drop_last=drop_last, epochs=3)
    for rank in range(world):
        with tdata.PrefetchLoader(tdata.ArraySource((x, y)), 3, rank=rank,
                                  world=world, **kw) as ours, \
                jdata.PrefetchLoader(jdata.ArraySource((x, y)), 3,
                                     rank=rank, world=world, **kw) as ref:
            per_epoch = ours.batches_remaining_in_epoch()
            assert per_epoch == ref.batches_remaining_in_epoch()
            head = _stream(ours, per_epoch - 1)
            _assert_streams_equal(head, _stream(ref, per_epoch - 1))
            assert ours.cursor() == ref.cursor()
            cur = ours.cursor()
            tail_ours = list(ours)
            tail_ref = [tuple(np.asarray(a) for a in b) for b in ref]
            _assert_streams_equal(
                [tuple(np.asarray(a) for a in b) for b in tail_ours],
                tail_ref)
            assert len(tail_ours) == 2 * per_epoch + 1
            # resume each package from the other's cursor
            for mod in (tdata, jdata):
                with mod.PrefetchLoader(mod.ArraySource((x, y)), 3,
                                        rank=rank, world=world,
                                        **kw) as again:
                    again.set_cursor(cur)
                    _assert_streams_equal(
                        [tuple(np.asarray(a) for a in b) for b in again],
                        tail_ref)


def test_cursor_across_world_and_elastic_reset_match_jax():
    """A world-2 cursor restored into world-1 loaders, and a loader
    re-sharded from 2 ranks to 3 by ``on_reset``, give the JAX loader's
    remaining streams."""
    x, y = _arrays(41)
    kw = dict(seed=1, shuffle=True, drop_last=True, epochs=2)
    with tdata.PrefetchLoader(tdata.ArraySource((x, y)), 2, rank=0,
                              world=2, **kw) as two:
        _stream(two, 4)
        cur = two.cursor()
    streams = []
    for mod in (tdata, jdata):
        with mod.PrefetchLoader(mod.ArraySource((x, y)), 2, rank=0,
                                world=1, **kw) as one:
            one.set_cursor(cur)
            streams.append(_stream(one, 6))
            one.on_reset(3, 1)
            streams.append(_stream(one, 5))
    _assert_streams_equal(streams[0], streams[2])
    _assert_streams_equal(streams[1], streams[3])


def test_file_source_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    files = {"img": [], "lbl": []}
    for k, n in enumerate((5, 9, 4)):
        for field, arr in (("img", rng.standard_normal((n, 2, 3))),
                           ("lbl", rng.integers(0, 5, size=(n,)))):
            p = tmp_path / f"{field}{k}.npy"
            np.save(p, arr)
            files[field].append(str(p))
    ours, ref = tdata.FileSource(files), jdata.FileSource(files)
    assert len(ours) == len(ref) == 18
    idx = rng.permutation(18)[:11]
    a, b = ours.batch(idx), ref.batch(idx)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="same number of files"):
        tdata.FileSource({"a": files["img"], "b": files["lbl"][:2]})


def test_loader_telemetry_is_not_ported():
    """The loader's telemetry was refused before the telemetry plane was
    ported; now ``telemetry=`` takes a ``DataInstruments`` of another
    registry, which counts the batches and staged bytes delivered."""
    from horovod_tpu_torch import telemetry as ttele
    x, y = _arrays()
    reg = ttele.MetricsRegistry()
    inst = ttele.data_instruments(reg)
    with tdata.PrefetchLoader(tdata.ArraySource((x, y)), 2, rank=0, world=1,
                              epochs=1, telemetry=inst) as loader:
        n = sum(1 for _ in loader)
    assert n > 0 and inst.batches.value == n
    assert inst.bytes_staged.value == n * 2 * (x[0].nbytes + y[0].nbytes)
    assert inst.wait_seconds.count == n


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def _mlp_step(loader=None):
    model = MLP(4, (8, 3))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    return model, t_training.make_train_step(model, opt, accum_steps=2,
                                             loader=loader)


def test_train_step_pulls_from_the_loader(cpu_world):
    """``step()`` takes the loader's batches (staged as tensors on the
    producer thread), and gives the losses of the same batches passed
    by hand; the step counts in ``step.state``."""
    x, y = _arrays(20)
    loader = tdata.PrefetchLoader(tdata.ArraySource((x, y)), 4, seed=3)
    assert (loader.rank, loader.world) == (0, 1)
    _, step = _mlp_step(loader)
    assert loader.placement_spec == torch.device("cpu")
    pulled = [float(step()) for _ in range(7)]  # across an epoch boundary
    assert step.state.step == 7
    assert loader.cursor()["epoch"] == 1
    loader.close()

    _, by_hand = _mlp_step()
    plain = tdata.PrefetchLoader(tdata.ArraySource((x, y)), 4, seed=3)
    want = [float(by_hand(*(torch.from_numpy(a) for a in next(plain))))
            for _ in range(7)]
    plain.close()
    assert pulled == want


def test_train_step_batch_errors(cpu_world):
    _, step = _mlp_step()
    with pytest.raises(TypeError, match="needs a loader"):
        step()
    with pytest.raises(TypeError, match="inputs, labels"):
        step(torch.zeros(4, 4))
    x, _ = _arrays(8)
    loader = tdata.PrefetchLoader(tdata.ArraySource((x,)), 4)
    _, step = _mlp_step(loader)
    with pytest.raises(TypeError, match=r"\(inputs, labels\)"):
        step()
    loader.close()
