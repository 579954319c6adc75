"""DeepRecSys in JAX: an at-scale recommendation inference framework.

A ground-up JAX/XLA re-design with the capabilities of
harvard-acc/DeepRecSys (reference layout documented in SURVEY.md):

- ``config``   — model/serving configuration (reference: utils/utils.py cli()
  + models/configs/*.json)
- ``ops``      — compute primitives: fused multi-table embedding bag,
  MLP towers, feature interactions, scanned RNN (reference: Caffe2
  SparseLengthsSum / FC / Concat+BatchMatMul / RecurrentNetwork)
- ``models``   — the eight industry model families: DLRM-RMC1/2/3, WnD,
  MT-WnD, NCF, DIN, DIEN (reference: models/*.py)
- ``data``     — synthetic query/data generators (reference: data_generator/)
- ``serving``  — load generator, inference engines, DeepRecSched scheduler,
  metrics aggregation (reference: loadGenerator.py, inferenceEngine.py,
  scheduler.py, DeepRecSys.py)
- ``parallel`` — device-mesh sharding of embedding tables and batch
  (no reference equivalent; the reference is single-node multiprocess)
"""

__version__ = "0.1.0"

from deeprecsys_tpu.config import ModelConfig, ServingConfig, load_model_config

__all__ = [
    "ModelConfig",
    "ServingConfig",
    "load_model_config",
    "zoo",
]


def __getattr__(name):
    # Lazy heavyweight imports (jax-dependent) so `import deeprecsys_tpu`
    # stays light for config-only use.
    import importlib

    if name == "zoo":
        mod = importlib.import_module("deeprecsys_tpu.zoo")
        globals()[name] = mod
        return mod
    if name == "Trainer":
        return importlib.import_module("deeprecsys_tpu.train").Trainer
    if name == "run_serving":
        return importlib.import_module("deeprecsys_tpu.serving").run_serving
    raise AttributeError(name)
