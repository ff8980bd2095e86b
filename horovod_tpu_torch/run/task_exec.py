"""The task body of the shipped-function executors (``run_task.py``, the
worker of ``run(fn)``, and ``cluster.cluster_task``): the port of
``horovod_tpu/run/task_exec.py``.

Both publish a ``(ok, value or traceback)`` payload to the launcher's
key-value store however ``fn`` ends, since a worker that dies silently
leaves the launcher polling until its timeout. Control flow (an
interrupt, ``SystemExit``) is published as a failure and then raised
again, so that the signal keeps its meaning.
"""

import pickle
import traceback


def exec_and_publish(fn, args, kwargs, publish):
    """Run ``fn(*args, **kwargs)`` and hand ``publish`` the pickled
    ``(ok, value)`` payload. True on success; False when ``fn`` raised an
    ordinary ``Exception`` (its traceback published). Any other
    ``BaseException`` is published as a failure and raised again."""
    try:
        payload = pickle.dumps((True, fn(*args, **kwargs)))
    except Exception:
        publish(pickle.dumps((False, traceback.format_exc())))
        return False
    except BaseException:
        publish(pickle.dumps((False, traceback.format_exc())))
        raise
    publish(payload)
    return True
