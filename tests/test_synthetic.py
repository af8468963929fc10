"""Corpus-free end-to-end test: render synthetic meter frames with known
dial positions and verify the full decode graph recovers them. Also
exercises the error paths with adversarial inputs."""
import numpy as np
import pytest

from meterelf_jax import synthetic
from meterelf_jax.errors import ErrCode
from meterelf_jax.pipeline.decode import MeterDecoder


@pytest.fixture(scope="module")
def syn_params(tmp_path_factory):
    return synthetic.make_params(str(tmp_path_factory.mktemp("syn")))


@pytest.fixture(scope="module")
def syn_decoder(syn_params):
    return MeterDecoder(syn_params, exact=True)


def test_synthetic_roundtrip(syn_params, syn_decoder):
    true_pos = [[(i * 1.7 + d * 2.3) % 10 for d in range(4)] for i in range(8)]
    crops = synthetic.render_crops(true_pos)
    res = syn_decoder.decode_numpy(crops)
    assert (res.err == ErrCode.OK).all()
    assert res.converged.all()
    err = np.abs(((res.dial_pos - np.array(true_pos)) + 5) % 10 - 5)
    assert err.max() < 0.1


def test_blank_frames_fail_template_match(syn_params, syn_decoder):
    crops = np.full((8, 250, 250, 3), 128, np.uint8)
    res = syn_decoder.decode_numpy(crops)
    assert (res.err == ErrCode.DIALS_NOT_FOUND).all()


def test_load_failure_flag(syn_params, syn_decoder):
    true_pos = [[1.0, 2.0, 3.0, 4.0]] * 8
    crops = synthetic.render_crops(true_pos)
    ok = np.ones(8, bool)
    ok[3] = False
    res = syn_decoder.decode_numpy(crops, ok)
    assert res.err[3] == ErrCode.LOAD
    assert (np.delete(res.err, 3) == ErrCode.OK).all()


def test_stub_needle_is_unreadable(syn_params, syn_decoder):
    """A needle stub that never reaches the tip annulus makes that dial
    unreadable (DialAngleDeterminingError path, _reading.py:98-106);
    the other dials still read."""
    frame = synthetic.render_frame([1.0, 2.0, 3.0, 4.0], stub_dials=(2,))
    (x0, y0), (x1, y1) = synthetic.METER_RECT
    crops = frame[None, y0:y1, x0:x1]
    res = syn_decoder.decode_numpy(np.ascontiguousarray(crops))
    assert res.err[0] == ErrCode.DIAL_ANGLE
    assert res.unreadable_bits[0] == (1 << 2)
    assert res.readable[0].tolist() == [True, True, False, True]


def test_alt_camera_geometry_roundtrip(tmp_path):
    """A second synthetic camera with a DIFFERENT template size (141x90)
    and crop size (210x200) decodes end-to-end through the generic XLA
    paths — the framework is not hardwired to the reference's shape
    family (reference analog: sample-images2's second params.yml)."""
    cam = synthetic.ALT_CAMERA
    params = cam.make_params(str(tmp_path))
    dec = MeterDecoder(params, exact=True)
    true_pos = [[(i * 2.1 + d * 1.3) % 10 for d in range(4)]
                for i in range(4)]
    crops = cam.render_crops(true_pos)
    assert crops.shape == (4, 200, 210, 3)
    res = dec.decode_numpy(crops)
    assert (res.err == ErrCode.OK).all()
    assert res.converged.all()
    err = np.abs(((res.dial_pos - np.array(true_pos)) + 5) % 10 - 5)
    assert err.max() < 0.1
