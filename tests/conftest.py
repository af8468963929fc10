import os

# Tests run on the CPU, on a virtual 8-device mesh: multi-chip sharding
# is validated without accelerator hardware. Tests that need the GPU
# carry the `gpu` marker and skip here (the `gpu` fixture decides at run
# time); chip_smoke.py runs the same checks on the card. On a GPU host,
# METERELF_GPU_TESTS=1 leaves the platform choice to JAX so that
# `python -m pytest -m gpu tests/test_gpu.py` reaches the card.
if os.environ.get("METERELF_GPU_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
if "--xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

os.environ.setdefault("METERELF_BATCH_SIZE", "8")  # small batches: fast compile

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

SAMPLE1 = "/root/reference/sample-images1"
SAMPLE2 = "/root/reference/sample-images2"
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "synthetic")


def _has_samples():
    return os.path.isdir(SAMPLE1)


def pytest_collection_modifyitems(config, items):
    if not _has_samples():
        skip = pytest.mark.skip(reason="reference sample images not available")
        for item in items:
            if "needs_samples" in item.keywords:
                item.add_marker(skip)


@pytest.fixture
def gpu():
    """The GPU device for a `gpu`-marked test; skips on hosts without
    one (decided at run time, never at import or collection)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check "
                    "on the card")
    return devs[0]


@pytest.fixture(scope="session")
def params1():
    from meterelf_jax.params import Params

    return Params.load(f"{SAMPLE1}/params.yml")


@pytest.fixture(scope="session")
def params2():
    from meterelf_jax.params import Params

    return Params.load(f"{SAMPLE2}/params.yml")


@pytest.fixture(scope="session")
def decoder1(params1):
    from meterelf_jax.pipeline.decode import MeterDecoder

    return MeterDecoder(params1, exact=True)


@pytest.fixture(scope="session", params=["default", "alt"])
def fixture_camera(request):
    """(name, camera dir, Params) of one committed synthetic camera."""
    from meterelf_jax.params import Params

    d = os.path.join(FIXTURES, request.param)
    return request.param, d, Params.load(os.path.join(d, "params.yml"))
