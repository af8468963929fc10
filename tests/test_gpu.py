"""The card-only numeric checks of chip_smoke.py phase 1, as tests: they
need an NVIDIA GPU and skip elsewhere (`gpu` fixture). On the card, in
one process: ``METERELF_GPU_TESTS=1 python -m pytest -p no:xdist -m gpu
tests/test_gpu.py``."""
import pytest

pytestmark = pytest.mark.gpu


def test_hls_exhaustive_on_gpu(gpu):
    from meterelf_jax import devicecheck

    assert devicecheck.check_hls_exhaustive(gpu) == 1 << 24


def test_template_match_on_gpu_matches_cpu(gpu):
    import jax

    from meterelf_jax import devicecheck

    rel = devicecheck.check_template_match(gpu, jax.devices("cpu")[0])
    assert set(rel) == {"default", "alt"}
