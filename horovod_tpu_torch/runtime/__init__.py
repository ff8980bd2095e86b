"""Host services attached at ``init()`` time: the port of
``horovod_tpu/runtime/`` (``services.py``, with the start of the native
host core, ``_core.py``, which the classic adapters call at their first
collective, and the stall inspector, ``stall.py``)."""
