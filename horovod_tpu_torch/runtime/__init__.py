"""Host-side services attached at ``init()`` time: the port of
``horovod_tpu/runtime/``'s telemetry part (``services.py``). The stall
inspector (``runtime/stall.py``) and the native-core controller wait
for ROADMAP items 6 and 8."""
