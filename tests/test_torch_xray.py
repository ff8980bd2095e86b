"""The port's step X-ray over ``torch.profiler`` traces, held to the JAX
package's rules: the name table (a row per entry), synthetic traces in
torch's Chrome format for each case of ``tests/test_xray.py``
(overlapped and exposed collectives, the host thread, a torn capture,
the unattributed gate, innermost-wins, the verdicts, the byte join),
``find_capture`` on the ``plugins/profile`` layout, and a real CPU
capture of the GSPMD LM step that both packages' ``hvd-doctor xray``
read."""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu.telemetry import xprof as jxprof
from horovod_tpu_torch.diag import xray as xray_doctor
from horovod_tpu_torch.telemetry import xprof

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def test_categories_gate_and_verdicts_are_the_jax_ones():
    assert xprof.CATEGORIES == jxprof.CATEGORIES
    assert xprof.COMPUTE_CATEGORIES == jxprof.COMPUTE_CATEGORIES
    assert xprof.BUCKETED_GATE == jxprof.BUCKETED_GATE == 0.95
    assert xprof.VERDICTS == jxprof.VERDICTS
    assert xprof.SUMMARY_PREFIX == jxprof.SUMMARY_PREFIX
    for k in ("EXPOSED_COMMS_BOUND", "OVERLAP_BROKEN_COLL",
              "OVERLAP_BROKEN_EXPOSED", "COPY_BOUND", "IDLE_BOUND"):
        assert getattr(xprof, k) == getattr(jxprof, k), k


# (name, trace cat, category; None: a host range, no device work)
NAME_TABLE = [
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT", "kernel", "matmul_conv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "kernel", "matmul_conv"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>"
     "(Params)", "kernel", "matmul_conv"),
    ("ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_32x5_tn",
     "kernel", "matmul_conv"),
    ("void cudnn::engines_precompiled::conv2d_grouped_direct_kernel<float>"
     "()", "kernel", "matmul_conv"),
    ("void flash_fwd_sm90<128, 64, 2>(FwdParams)", "kernel", "other_op"),
    ("flash_dkv_sm90_kernel", "kernel", "other_op"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int, float*)", "kernel",
     "other_op"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
     "<FusedAdamMathFunctor>()", "kernel", "other_op"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda,"
     " convert>()", "kernel", "other_op"),
    ("triton_poi_fused_add_mul_0", "kernel", "fusion"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "kernel", "all_reduce"),
    ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL()", "kernel",
     "reduce_scatter"),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t()", "kernel", "all_gather"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", "kernel",
     "collective_permute"),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", "copy"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", "copy"),
    ("Memset (Device)", "gpu_memset", "copy"),
    ("ProfilerStep#3", "gpu_user_annotation", None),
    ("aten::mm", "cpu_op", "matmul_conv"),
    ("aten::addmm", "cpu_op", "matmul_conv"),
    ("aten::bmm", "cpu_op", "matmul_conv"),
    ("aten::convolution", "cpu_op", "matmul_conv"),
    ("aten::copy_", "cpu_op", "copy"),
    ("aten::_to_copy", "cpu_op", "copy"),
    ("aten::softmax", "cpu_op", "other_op"),
    ("aten::linear", "cpu_op", "other_op"),
    ("c10d::allreduce_", "cpu_op", "all_reduce"),
    ("_c10d_functional::reduce_scatter_tensor", "cpu_op", "reduce_scatter"),
    ("record_param_comms", "user_annotation", None),
    ("nn.Module: Transformer_0", "python_function", None),
    ("cudaLaunchKernel", "cuda_runtime", "unattributed"),
]


@pytest.mark.parametrize("name,cat,want", NAME_TABLE,
                         ids=[f"{c}:{n[:28]}" for n, c, _ in NAME_TABLE])
def test_name_table(name, cat, want):
    assert xprof.event_category(name, cat) == want


# -- synthetic traces in torch's Chrome format --------------------------------

def _ev(name, ts, dur, cat="kernel", pid=0, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": float(ts), "dur": float(dur), "args": args}


GEMM = "nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>()"
AR = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"


def _overlapped():
    """Stream 7 computes (gemm 0-100 us, elementwise 100-140); NCCL's
    stream 20 all-reduces 10-120 us, inside the compute; the host's
    cpu_ops (a 200 us aten::mm) and the annotation projected onto
    stream 7 are no device work."""
    return [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
        _ev(GEMM, 0, 100), _ev(ADD, 100, 40),
        _ev(AR, 10, 110, tid=20),
        _ev("ProfilerStep#1", 0, 150, cat="gpu_user_annotation"),
        _ev("aten::mm", 0, 200, cat="cpu_op", pid=100, tid=1),
        _ev("cudaLaunchKernel", 5, 3, cat="cuda_runtime", pid=100, tid=1),
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0,
         "tid": 7, "ts": 0},
    ]


def _exposed():
    """A gemm 0-40 us, a host-to-device copy 40-50, nothing 50-60, then
    an all-gather 60-90 and a reduce-scatter 90-100 with no compute
    behind them."""
    return [
        _ev(GEMM, 0, 40), _ev("Memcpy HtoD (Pageable -> Device)", 40, 10,
                              cat="gpu_memcpy"),
        _ev("ncclDevKernel_AllGather_RING_LL()", 60, 30, tid=20),
        _ev("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL()", 90, 10,
            tid=20),
    ]


def test_overlapped_collective_hides_behind_compute():
    s = xprof.attribute(_overlapped())
    ar = s["collectives"]["all_reduce"]
    assert ar["events"] == 1
    assert ar["seconds"] == pytest.approx(110e-6, rel=1e-6)
    assert ar["overlapped_seconds"] == pytest.approx(110e-6, rel=1e-6)
    assert ar["exposed_seconds"] == 0.0
    assert s["verdict"] == "compute-bound"
    assert s["bucketed_fraction"] == pytest.approx(1.0)


def test_host_lanes_and_annotations_stay_out():
    """Only the two streams are lanes; the host's 200 us aten::mm stays
    out, and the annotation around the kernels takes no self time (kept
    in, it would claim the 140-150 us gap)."""
    s = xprof.attribute(_overlapped())
    assert s["device_lanes"] == 2
    assert s["busy_seconds"] == pytest.approx(140e-6, rel=1e-6)
    assert s["window_seconds"] == pytest.approx(140e-6, rel=1e-6)
    total = sum(s["device_seconds"].values())
    assert total == pytest.approx(250e-6, rel=1e-6)  # 140 + AR's 110
    assert s["device_seconds"]["idle"] == 0.0


def test_exposed_collective_with_no_compute_behind_it():
    s = xprof.attribute(_exposed())
    ag = s["collectives"]["all_gather"]
    rs = s["collectives"]["reduce_scatter"]
    assert ag["exposed_seconds"] == pytest.approx(30e-6, rel=1e-6)
    assert ag["overlapped_seconds"] == 0.0
    assert rs["exposed_seconds"] == pytest.approx(10e-6, rel=1e-6)
    assert s["verdict"] == "comms-bound"
    assert s["device_seconds"]["matmul_conv"] == pytest.approx(40e-6,
                                                               rel=1e-6)
    assert s["device_seconds"]["copy"] == pytest.approx(10e-6, rel=1e-6)
    assert s["device_seconds"]["idle"] == pytest.approx(10e-6, rel=1e-6)


def test_cpu_trace_lanes_are_the_operator_threads():
    """A CPU trace has no device lanes: the thread of cpu_ops is the
    lane, its nested aten calls resolve innermost-wins, python_function
    and user_annotation ranges stay host, and a gloo collective is
    named."""
    events = [
        _ev("ProfilerStep#0", 0, 300, cat="user_annotation", pid=5, tid=1),
        _ev("nn.Module: Linear", 0, 300, cat="python_function", pid=5,
            tid=1),
        _ev("aten::linear", 0, 100, cat="cpu_op", pid=5, tid=1),
        _ev("aten::addmm", 20, 50, cat="cpu_op", pid=5, tid=1),
        _ev("aten::copy_", 110, 20, cat="cpu_op", pid=5, tid=1),
        _ev("c10d::allreduce_", 200, 50, cat="cpu_op", pid=5, tid=1),
    ]
    s = xprof.attribute(events)
    assert s["device_lanes"] == 1
    d = s["device_seconds"]
    assert d["other_op"] == pytest.approx(50e-6, rel=1e-6)
    assert d["matmul_conv"] == pytest.approx(50e-6, rel=1e-6)
    assert d["copy"] == pytest.approx(20e-6, rel=1e-6)
    assert d["all_reduce"] == pytest.approx(50e-6, rel=1e-6)
    assert d["idle"] == pytest.approx(80e-6, rel=1e-6)  # 100-110, 130-200
    assert s["collectives"]["all_reduce"]["exposed_seconds"] == \
        pytest.approx(50e-6, rel=1e-6)
    assert s["bucketed_fraction"] == pytest.approx(1.0)


def test_self_time_innermost_wins():
    events = [_ev("triton_red_fused_0", 0, 100),
              _ev(GEMM, 20, 30)]
    s = xprof.attribute(events)
    assert s["device_seconds"]["fusion"] == pytest.approx(70e-6, rel=1e-6)
    assert s["device_seconds"]["matmul_conv"] == pytest.approx(30e-6,
                                                               rel=1e-6)


def test_unattributed_device_time_fails_the_gate():
    """An event of no known kind on a device lane stays unattributed and
    pulls the named share under the gate."""
    events = [_ev(GEMM, 0, 10),
              _ev("SomeNewDeviceThing", 10, 90, cat="gpu_new_activity")]
    s = xprof.attribute(events)
    assert s["device_seconds"]["unattributed"] == pytest.approx(90e-6,
                                                                rel=1e-6)
    assert s["bucketed_fraction"] < xprof.BUCKETED_GATE


def test_verdict_rules():
    def summary(cats, colls):
        base = {c: 0.0 for c in xprof.CATEGORIES}
        base.update(cats)
        return {"device_lanes": 1, "device_seconds": base,
                "collectives": colls}
    cases = [
        (summary({"matmul_conv": 1.0}, {}), "compute-bound"),
        (summary({"matmul_conv": 1.0, "all_reduce": 0.5},
                 {"all_reduce": {"seconds": 0.5, "exposed_seconds": 0.5,
                                 "overlapped_seconds": 0.0}}),
         "comms-bound"),
        (summary({"matmul_conv": 1.0, "all_reduce": 0.15},
                 {"all_reduce": {"seconds": 0.15, "exposed_seconds": 0.12,
                                 "overlapped_seconds": 0.03}}),
         "overlap-broken"),
        (summary({"matmul_conv": 1.0, "copy": 0.3}, {}), "copy-bound"),
        (summary({"matmul_conv": 1.0, "idle": 0.8}, {}), "idle-bound"),
        (summary({}, {}), "empty-capture"),
    ]
    for s, want in cases:
        assert xprof.verdict(s) == jxprof.verdict(s) == want


def test_bandwidth_join_accepts_both_label_forms():
    events = [_ev(AR, 0, 40), _ev("ncclDevKernel_AllGather_RING_LL()", 0,
                                  20, tid=20)]
    s = xprof.attribute(events, steps=2)
    xprof.join_collective_bytes(
        s, {"spmd_all_reduce": {"calls": 1, "bytes": 1_000_000},
            "all-gather": {"calls": 1, "bytes": 500_000}}, steps=2)
    ar, ag = s["collectives"]["all_reduce"], s["collectives"]["all_gather"]
    assert ar["bytes_per_step"] == 1_000_000
    assert ar["effective_gbps"] == pytest.approx(100.0)
    assert ag["effective_gbps"] == pytest.approx(100.0)


def _capture(root, name, events=None, text=None, gz=False):
    run = root / "plugins" / "profile" / name
    run.mkdir(parents=True)
    body = text if text is not None else json.dumps(
        {"schemaVersion": 1, "traceEvents": events})
    if gz:
        with gzip.open(run / "host.trace.json.gz", "wt") as f:
            f.write(body)
    else:
        (run / "host.trace.json").write_text(body)
    return run


def test_find_capture_newest_run_gz_and_torn(tmp_path):
    old = _capture(tmp_path, "2026_01_01_00_00_00", _overlapped())
    new = _capture(tmp_path, "2026_01_02_00_00_00", _exposed(), gz=True)
    assert xprof.find_capture(str(tmp_path)) == (
        str(new), [str(new / "host.trace.json.gz")])
    s = xprof.analyze_capture(str(tmp_path))
    assert s["capture_dir"] == str(new) and s["verdict"] == "comms-bound"
    assert xprof.analyze_capture(str(old))["verdict"] == "compute-bound"
    assert xprof.find_capture(str(tmp_path / "none")) == (None, [])
    torn = _capture(tmp_path / "t", "r1", text='{"traceEvents": [{"ph"')
    with pytest.raises(ValueError):
        xprof.analyze_capture(str(tmp_path / "t"))
    (torn / "b.trace.json").write_text(json.dumps(
        {"traceEvents": _exposed()}))
    s = xprof.analyze_capture(str(tmp_path / "t"))
    assert s["verdict"] == "comms-bound" and len(s["torn_files"]) == 1
    empty = xprof.attribute([])
    assert empty["verdict"] == "empty-capture" and \
        empty["device_lanes"] == 0


def test_doctor_xray_on_raw_capture_and_summaries(tmp_path, capsys):
    _capture(tmp_path / "raw", "r", _exposed())
    assert xray_doctor.main([str(tmp_path / "raw"), "--json"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out)["verdict"] == "comms-bound"
    assert "VERDICT: comms-bound" in out.err
    s = xprof.attribute(_overlapped())
    assert xprof.write_summary(s, str(tmp_path / "sum"), rank=3).endswith(
        "xray.rank3.json")
    from horovod_tpu_torch.diag.doctor import SUBCOMMANDS, doctor_cli
    assert set(SUBCOMMANDS) == {"hang", "perf", "serve", "xray"}
    assert doctor_cli(["xray", str(tmp_path / "sum"), "--json"]) == 0
    reread = json.loads(capsys.readouterr().out)
    assert reread["verdict"] == "compute-bound" and reread["rank"] == 3
    assert xray_doctor.main([str(tmp_path / "nothing")]) == 2
    # the serve route reads the serving plane's request dumps
    from horovod_tpu_torch.serve.tracing import RequestTrace, ServeTracer
    tracer = ServeTracer(sample=1.0, out_dir=str(tmp_path / "serve"))
    tr = RequestTrace("r-1", clock=lambda: 0.0)
    tr.phase(0.0, "queued")
    tr.span("prefill", 0.5, 1.0, actor="default")
    tr.phase(1.0, "decoding")
    tracer.finish(tr, end=2.0)
    tracer.close()
    capsys.readouterr()
    assert doctor_cli(["serve", str(tmp_path / "serve"), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["requests"] == 1 and report["verdict"] == "decode_batch_dilation"
    assert doctor_cli(["serve", str(tmp_path / "nothing")]) == 2


# -- a real CPU capture of the GSPMD LM step -----------------------------------

@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def test_a_failed_step_still_closes_a_due_profile_window(cpu_world,
                                                          tmp_path):
    """A ``/profile`` window that a step opened closes when its time has
    passed even if that step raises: the capture does not stay open
    until a later step succeeds."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    model = Transformer(TransformerConfig(
        vocab_size=16, num_layers=1, num_heads=2, d_model=8, d_ff=16,
        dtype=torch.float32), generator=torch.Generator().manual_seed(0))
    opt = hvd_t.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.1))
    step = training.make_lm_train_step(model, opt)

    def fail(*a, **k):
        raise RuntimeError("the step failed")

    model.forward = fail
    window = xprof.open_window(str(tmp_path), 0.0)
    with pytest.raises(RuntimeError, match="the step failed"):
        step(torch.zeros(2, 8, dtype=torch.long))
    assert window.done.is_set() and window.steps == 1
    assert window.error is None and window.run_dir is not None
    assert xprof._window is None


def test_gspmd_lm_step_xray_on_a_real_cpu_capture(cpu_world, tmp_path,
                                                  capsys):
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.telemetry import instruments as tinst
    from horovod_tpu_torch.telemetry import ledger as tled
    cfg = TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                            d_model=32, d_ff=64, dtype=torch.float32)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    opt = hvd_t.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.1))
    step = training.make_lm_train_step(model, opt, spmd=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, size=(4, 16)))
    loss, summary = step.xray(tokens, k=2, profile_dir=str(tmp_path))
    assert torch.isfinite(loss)
    assert summary["steps"] == 2 and summary["device_lanes"] >= 1
    assert summary["bucketed_fraction"] >= xprof.BUCKETED_GATE
    assert summary["verdict"] in xprof.VERDICTS
    assert xprof.dominant_sink(summary)[0] is not None
    assert (tmp_path / "xray.rank0.json").exists()
    assert tinst.XRAY_BUCKETED_FRACTION in \
        tinst.get_registry().render_prometheus()
    led = tled.get_ledger().snapshot()
    assert led["compiled_path"] and led["steps"] == 3
    assert led["phases"]["compile"] > 0  # the first call's signature
    # the port's doctor reads the summary, and so does the JAX one
    assert xray_doctor.main([str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["bucketed_fraction"] == \
        summary["bucketed_fraction"]
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from horovod_tpu.diag.doctor import doctor_cli; "
         "sys.exit(doctor_cli(sys.argv[1:]))", "xray", str(tmp_path),
         "--json"], capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    theirs = json.loads(out.stdout)
    assert theirs["verdict"] == summary["verdict"]
    assert theirs["device_seconds"] == summary["device_seconds"]
