"""End-to-end fuzz against the REFERENCE pipeline as an executable
oracle: random synthetic frames (random needle angles, cluster offsets,
stub needles, pixel noise, speckle clusters near the dials) are decoded
by our batched graph AND by the reference package itself (executed from
/root/reference with the same compat shims the golden-parity work
validated — cv2-3 API arities, old-cv2-exact HLS, pyyaml Loader), then
compared.

This covers the space the golden corpus cannot: arbitrary needle
configurations, carry-correction boundaries, unreadable dials, noisy
masks, near-threshold contour areas, and a second camera geometry
(ALT_CAMERA).
"""
import os

import numpy as np
import pytest

REF = "/root/reference"

cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "meterelf")),
    reason="reference package not mounted")


@pytest.fixture(scope="module", params=["default", "alt"])
def oracle(request, tmp_path_factory):
    """(decode_frame, params, camera): the shimmed reference pipeline
    over one synthetic camera geometry."""
    import yaml
    from meterelf_jax import synthetic

    camera = (synthetic.DEFAULT_CAMERA if request.param == "default"
              else synthetic.ALT_CAMERA)
    d = str(tmp_path_factory.mktemp(f"oracle_cam_{request.param}"))
    params = camera.make_params(d)  # writes the template PNG
    yml = os.path.join(d, "params.yml")
    with open(yml, "w") as fp:
        yaml.safe_dump(
            camera.params_dict(os.path.join(d, "synthetic_template.png")),
            fp)

    # shims live in tests/ref_shims.py (reference runs as an oracle,
    # never copied)
    from ref_shims import shimmed_reference

    with shimmed_reference() as ref:
        r_image, r_reading = ref["_image"], ref["_reading"]
        ref_params = ref["_params"].load(yml)

        def decode_frame(frame_bgr):
            """-> (meter_values dict | None, error-class-name | None)"""
            imgf = r_image.ImageFile("<fuzz>", ref_params, frame_bgr)
            try:
                return r_reading.get_meter_value(imgf), None
            except Exception as exc:  # reference error taxonomy
                return None, type(exc).__name__

        yield decode_frame, params, camera


from fuzz_frames import fuzz_frames as _frames  # noqa: E402 (shared
# with chip_smoke.py's GPU-vs-CPU fuzz phase — same input space)


def _run_and_compare(oracle, frames, chunk=8):
    from meterelf_jax.errors import ErrCode
    from meterelf_jax.pipeline.decode import MeterDecoder

    decode_frame, params, camera = oracle
    (x0, y0), (x1, y1) = camera.meter_rect
    crops = np.stack([f[y0:y1, x0:x1] for f in frames])

    dec = MeterDecoder(params, exact=True)
    fields = None
    for i0 in range(0, len(crops), chunk):
        part = crops[i0:i0 + chunk]
        if len(part) < chunk:  # pad to the compiled batch shape
            part = np.concatenate(
                [part, np.repeat(part[-1:], chunk - len(part), axis=0)])
        r = dec.decode_numpy(part)
        fields = (r if fields is None
                  else type(r)(*[np.concatenate([a, b])
                                 for a, b in zip(fields, r)]))
    res = fields

    name_order = [s[0] for s in camera.dial_specs]
    mismatches = []
    for i, f in enumerate(frames):
        mv, err_name = decode_frame(f)
        if err_name is None:
            if res.err[i] != ErrCode.OK:
                mismatches.append((i, "oracle ok, ours err",
                                   int(res.err[i])))
                continue
            if "value" in mv and abs(
                    float(res.value[i]) - mv["value"]) > 5e-6:
                mismatches.append((i, "value", float(res.value[i]),
                                   mv["value"]))
            for d, nm in enumerate(name_order):
                if nm in mv and abs(
                        float(res.dial_pos[i, d]) - mv[nm]) > 5e-6:
                    mismatches.append((i, f"dial {nm}",
                                       float(res.dial_pos[i, d]), mv[nm]))
            continue
        expected = {
            "DialsNotFoundError": ErrCode.DIALS_NOT_FOUND,
            "NeedleContoursNotFoundError": ErrCode.NEEDLE_CONTOURS,
            "DialAngleDeterminingError": ErrCode.DIAL_ANGLE,
        }.get(err_name)
        if expected is None:
            mismatches.append((i, "unexpected oracle error", err_name))
        elif res.err[i] != expected:
            mismatches.append((i, "error code", int(res.err[i]), err_name))
    assert not mismatches, mismatches


# Scale knobs for one-off big fuzz campaigns (default = the CI run):
# METERELF_FUZZ_SEEDS="7,101,202,303,..." METERELF_FUZZ_N=150 pytest ...
_SEEDS = [int(s) for s in
          os.environ.get("METERELF_FUZZ_SEEDS", "7,101,202").split(",")]
_N = int(os.environ.get("METERELF_FUZZ_N", "70"))


@pytest.mark.parametrize("seed", _SEEDS)
def test_fuzz_against_reference_oracle(oracle, seed):
    _, _, camera = oracle
    from meterelf_jax import synthetic

    # 3 seeds x 70 frames on the fused-path camera (>= 200 total);
    # the alt geometry runs one seed through the generic paths
    if camera is synthetic.ALT_CAMERA:
        if seed != _SEEDS[0]:
            pytest.skip("alt geometry runs one seed")
        n = max(40, _N * 4 // 7)
    else:
        n = _N
    _run_and_compare(oracle, _frames(camera, n, seed))
