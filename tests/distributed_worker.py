"""Worker for the multi-process distributed test (spawned by
test_distributed.py; must be an importable module for mp 'spawn').

Each process owns 2 virtual CPU devices; together they form a 4-device
(data=2, model=2) GLOBAL mesh — the 2-host topology of BASELINE.md's
scaling target, with Gloo carrying the cross-process collectives that
NVLink or the network would carry between real hosts.
"""

import os


def run_worker(pid: int, n_proc: int, port: int, q):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        from deeprecsys_tpu.parallel import distributed_init

        distributed_init(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=n_proc, process_id=pid)
        import jax.numpy as jnp
        import numpy as np

        from deeprecsys_tpu import zoo
        from deeprecsys_tpu.data import RecDataGenerator
        from deeprecsys_tpu.models import get_model
        from deeprecsys_tpu.models.base import Batch
        from deeprecsys_tpu.parallel import make_mesh, shard_params, sharded_apply
        from deeprecsys_tpu.parallel.sharding import batch_shardings

        assert len(jax.devices()) == 2 * n_proc

        cfg = zoo.get_config("rm1", table_scale=5000)
        model = get_model(cfg)
        # Identical seeds on every process -> identical host params/data.
        params = model.init(jax.random.PRNGKey(0))
        host = RecDataGenerator(cfg, seed=1).generate_batch(8)
        single = np.asarray(model.apply(params, host))

        mesh = make_mesh(data=2, model=2)  # all 4 global devices
        sp = shard_params(params, mesh)
        fn = sharded_apply(model.apply, params, mesh, has_dense=True)
        sh = batch_shardings(mesh, has_dense=True)
        batch = Batch(dense=jax.device_put(jnp.asarray(host.dense), sh.dense),
                      indices=jax.device_put(jnp.asarray(host.indices), sh.indices))
        out = fn(sp, batch)
        # The output is data-sharded across processes; gather it for the check.
        got = np.asarray(jax.device_get(
            jax.jit(lambda x: x, out_shardings=jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()))(out)))
        err = float(np.max(np.abs(got - single)))
        q.put((pid, "ok", err))
    except Exception as e:  # pragma: no cover - surfaced by the test
        q.put((pid, "error", repr(e)[:400]))
