"""Host-side services attached at ``init()`` time: the port of
``horovod_tpu/runtime/`` (``services.py``, and the stall inspector,
``stall.py``). Only the native-core controller waits, for ROADMAP
Queue 1 item 4a (the port's shim over the native core)."""
