"""Workers that the port's launcher runs: ``lm_benchmark`` (the LM
benchmark, ``python -m horovod_tpu_torch.examples.lm_benchmark``) and
``probe`` (a function for ``horovod_tpu_torch.run.run``)."""
