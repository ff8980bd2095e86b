"""The port's example drivers, each the twin of one in ``examples/``, at
its flags and defaults, and ``probe`` (a function for
``horovod_tpu_torch.run.run``). Each driver is a module with
``main(argv=None)``, run as ``python -m horovod_tpu_torch.examples.<name>``
alone or under ``hvdrun-torch`` (``python -m horovod_tpu_torch.run``); it
runs on this rank's card unless given ``--device cpu`` (the TensorFlow and
MXNet drivers run on the CPU, as their twins do).

* ``lm_benchmark``: ``jax_lm_benchmark.py``; with ``--data D --seq S``
  ``jax_lm_seq_parallel.py``, with ``--model M``
  ``jax_lm_tensor_parallel.py``, with ``--expert N --moe-every 2``
  ``jax_lm_moe.py``;
* ``elastic_train``: ``elastic_train.py``;
* ``checkpoint_resume``: ``jax_checkpoint_resume.py``;
* ``mnist``: ``jax_mnist.py``;
* ``imagenet_resnet50``: ``jax_imagenet_resnet50.py``;
* ``synthetic_benchmark``: ``jax_synthetic_benchmark.py``;
* ``hierarchical_allreduce``: ``jax_hierarchical_allreduce.py``;
* Horovod's classic drivers over the port's adapters
  (``horovod_tpu_torch.torch``, ``.tensorflow``, ``.mxnet``):
  ``pytorch_mnist``: ``pytorch_mnist.py``; ``pytorch_synthetic_benchmark``:
  ``pytorch_synthetic_benchmark.py``; ``tensorflow2_keras_mnist``:
  ``tensorflow2_keras_mnist.py``; ``tensorflow2_mnist``:
  ``tensorflow2_mnist.py``; ``mxnet_mnist``: ``mxnet_mnist.py``.
"""
