"""Execute the reference package from /root/reference as an oracle.

The shims adapt the py3.6/cv2-3.4-era reference to the modern stack —
the exact compat set the golden-parity work validated (SURVEY.md §8bis):
pyyaml Loader requirement, cv2-4+ findContours arity, cv2-5 findNonZero
shape, and the old-cv2-exact float-path HLS conversion the goldens
embed. The reference code is imported and executed, never copied.
"""
import contextlib
import sys

import numpy as np

REF = "/root/reference"


@contextlib.contextmanager
def shimmed_reference():
    """Yield the reference's module namespace under compat shims."""
    import cv2
    import yaml

    from meterelf_jax.api import _host_hls

    real_yaml_load = yaml.load
    yaml.load = lambda stream, Loader=None: real_yaml_load(
        stream, Loader=yaml.SafeLoader)

    real_find_contours = cv2.findContours

    def find_contours3(*a, **k):
        contours, hier = real_find_contours(*a, **k)
        return (None, contours, hier)

    cv2.findContours = find_contours3

    real_find_non_zero = cv2.findNonZero

    def find_non_zero_legacy(img):
        r = real_find_non_zero(img)
        if r is None or r.ndim == 3:
            return r
        return r.reshape(-1, 1, 2)

    cv2.findNonZero = find_non_zero_legacy

    real_cvt = cv2.cvtColor

    def cvt_exact(img, code):
        if code == cv2.COLOR_BGR2HLS_FULL:
            # old-cv2 float-path exact conversion (the one the goldens
            # embed; modern cv2 differs by +-1 LSB on ~half of H values)
            return _host_hls(img, 0).astype(np.uint8)
        return real_cvt(img, code)

    cv2.cvtColor = cvt_exact

    sys.path.insert(0, REF)
    try:
        import meterelf
        from meterelf import _image, _main, _params, _reading

        yield {
            "meterelf": meterelf,
            "_image": _image,
            "_main": _main,
            "_params": _params,
            "_reading": _reading,
        }
    finally:
        yaml.load = real_yaml_load
        cv2.findContours = real_find_contours
        cv2.findNonZero = real_find_non_zero
        cv2.cvtColor = real_cvt
        sys.path.remove(REF)
