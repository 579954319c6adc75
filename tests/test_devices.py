"""Device selection (utils/devices.py): a GPU when there is one, the CPU
only when JAX was explicitly told to use it, otherwise an error."""

from types import SimpleNamespace

import pytest

from deeprecsys_tpu.utils.devices import choose_accel, pick_accel_device


def _devs(*platforms):
    return [SimpleNamespace(platform=p, id=i) for i, p in enumerate(platforms)]


@pytest.mark.parametrize("devices, setting, want", [
    (("cpu", "gpu", "gpu"), None, 1),    # the first GPU wins
    (("gpu",), "cuda", 0),
    (("cpu",), "cpu", 0),                # explicit CPU is allowed
    (("cpu",), " cpu ,cpu", 0),
])
def test_choose_accel_picks(devices, setting, want):
    devs = _devs(*devices)
    assert choose_accel(devs, setting) is devs[want]


@pytest.mark.parametrize("setting", [None, "", "cuda,cpu", "rocm"])
def test_choose_accel_refuses_silent_cpu(setting):
    """No GPU and no explicit CPU setting: never fall back to the host."""
    with pytest.raises(RuntimeError, match="no GPU"):
        choose_accel(_devs("cpu", "cpu"), setting)


def test_pick_accel_device_under_explicit_cpu():
    """The test suite sets jax_platforms=cpu (conftest), so the picker
    hands out the CPU device."""
    assert pick_accel_device().platform == "cpu"


def _standalone():
    from deeprecsys_tpu.main import main

    main(["--model", "ncf", "--table_scale", "2000", "--num_batches", "2",
          "--mini_batch_size", "4"])


def _op_breakdown():
    from deeprecsys_tpu.experiments.op_breakdown import breakdown_for

    breakdown_for("ncf", batch_size=4, table_scale=2000)


def _payload_floor():
    from deeprecsys_tpu.utils.timing import payload_floor_fit

    payload_floor_fit(sizes_mb=(0.0, 0.1), trials=1)


def _roundtrip_floor():
    from deeprecsys_tpu.utils.timing import roundtrip_floor_ms

    roundtrip_floor_ms(trials=1)


@pytest.mark.parametrize("run", [_standalone, _op_breakdown,
                                 _payload_floor, _roundtrip_floor])
def test_measurement_paths_take_the_picked_device(run, monkeypatch):
    """Every timing path asks the picker for its device, so on a host
    without a GPU and without an explicit CPU setting it fails instead of
    timing the CPU."""
    from deeprecsys_tpu.utils import devices

    def no_gpu():
        raise RuntimeError("no GPU found")

    monkeypatch.setattr(devices, "pick_accel_device", no_gpu)
    with pytest.raises(RuntimeError, match="no GPU"):
        run()
