"""Both packages' classic adapters on one script, for the port's adapter
tests: ``run_both(module, body)`` runs ``body("horovod_tpu", {})`` on 2
ranks of the JAX package's ``run()`` and ``body("horovod_tpu_torch",
{"device": "cpu"})`` on 2 ranks of the port's, side by side, and returns
``(jax_results, port_results)``, each in rank order. ``module`` is the
calling test module: its workers cannot import it, so cloudpickle ships
its functions by value. The workers find ``tests/`` (the fakes of
TensorFlow and MXNet) on their path."""

import os
import threading

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def run_both(module, body, np=2):
    import cloudpickle

    from horovod_tpu.run import api as jax_api

    from horovod_tpu_torch.run import api as port_api
    path = os.pathsep.join(p for p in (TESTS_DIR,
                                       os.environ.get("PYTHONPATH")) if p)
    got = {}

    def run(key, api, fn, env):
        try:
            got[key] = api.run(fn, np=np, extra_env=dict(env,
                                                          PYTHONPATH=path))
        except BaseException as e:  # re-raised on the test's thread
            got[key] = e

    def jax_fn():
        return body("horovod_tpu", {})

    def port_fn():
        return body("horovod_tpu_torch", {"device": "cpu"})

    threads = [
        threading.Thread(target=run, args=("jax", jax_api, jax_fn,
                                           {"JAX_PLATFORMS": "cpu"})),
        threading.Thread(target=run, args=("port", port_api, port_fn,
                                           {"OMP_NUM_THREADS": "1"}))]
    cloudpickle.register_pickle_by_value(module)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        cloudpickle.unregister_pickle_by_value(module)
    for v in got.values():
        if isinstance(v, BaseException):
            raise v
    return got["jax"], got["port"]
