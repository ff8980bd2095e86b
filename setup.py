"""Packaging (reference role: ``setup.py:379-523`` — the reference
compiles its C++ core as a CPython extension at install time; here the
host core is a plain shared library loaded via ctypes, so the build step
shells out to ``cxx/Makefile`` and ships ``libhvdcore.so`` as package
data. ``pip install .`` produces a wheel with the native core prebuilt;
source checkouts still lazy-build on first import (``_core.build``)."""

import os
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py

HERE = os.path.abspath(os.path.dirname(__file__))


class BuildWithNativeCore(build_py):
    def run(self):
        subprocess.check_call(
            ["make", "-C", os.path.join(HERE, "cxx"),
             "-j", str(os.cpu_count() or 2)])
        super().run()


setup(
    name="horovod_tpu",
    version="0.1.0",
    description=("TPU-native distributed training framework with "
                 "Horovod's capabilities (XLA collectives data plane, "
                 "C++ host core, MPI-free launcher)"),
    packages=["horovod_tpu", "horovod_tpu.analysis",
              "horovod_tpu.analysis.rules",
              "horovod_tpu.chaos",
              "horovod_tpu.ckpt", "horovod_tpu.data",
              "horovod_tpu.diag", "horovod_tpu.elastic",
              "horovod_tpu.jax", "horovod_tpu.models",
              "horovod_tpu.mxnet", "horovod_tpu.ops",
              "horovod_tpu.parallel", "horovod_tpu.run",
              "horovod_tpu.runtime", "horovod_tpu.serve",
              "horovod_tpu.spark", "horovod_tpu.telemetry",
              "horovod_tpu.tensorflow", "horovod_tpu.torch",
              "horovod_tpu.utils",
              # the PyTorch/CUDA port; its kernels build from csrc/ at
              # first use (horovod_tpu_torch/_build.py)
              "horovod_tpu_torch", "horovod_tpu_torch.chaos",
              "horovod_tpu_torch.ckpt", "horovod_tpu_torch.cluster",
              "horovod_tpu_torch.data", "horovod_tpu_torch.diag",
              "horovod_tpu_torch.elastic",
              "horovod_tpu_torch.examples",
              "horovod_tpu_torch.models", "horovod_tpu_torch.ops",
              "horovod_tpu_torch.parallel", "horovod_tpu_torch.run",
              "horovod_tpu_torch.runtime", "horovod_tpu_torch.serve",
              "horovod_tpu_torch.serve.fleet",
              "horovod_tpu_torch.telemetry",
              "horovod_tpu_torch.utils"],
    package_data={"horovod_tpu": ["lib/libhvdcore.so"],
                  "horovod_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=["numpy", "jax", "flax", "optax"],
    extras_require={
        "torch": ["torch"],
        "dev": ["pytest", "cloudpickle"],
    },
    entry_points={
        "console_scripts": [
            "hvdrun = horovod_tpu.run.run:main",
            "hvdrun-torch = horovod_tpu_torch.run.run:main",
            "hvd-doctor = horovod_tpu.diag.doctor:doctor_cli",
            "hvd-lint = horovod_tpu.analysis.cli:main",
            "hvd-serve = horovod_tpu.serve.cli:main",
            "hvd-serve-torch = horovod_tpu_torch.serve.cli:main",
        ],
    },
    cmdclass={"build_py": BuildWithNativeCore},
)
