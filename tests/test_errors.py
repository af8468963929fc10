"""Error message rendering parity (reference: meterelf/exceptions.py)."""
from meterelf_jax.errors import (
    DialAngleDeterminingError,
    DialsNotFoundError,
    ImageLoadingError,
    NeedleContoursNotFoundError,
)


def test_dials_not_found_message():
    e = DialsNotFoundError("x.jpg", extra_info={"match val": 17495704.0})
    assert e.get_message() == "Dials not found (match val = 17495704.0)"
    assert e.get_message(with_filename=True) == (
        "Dials not found from file: x.jpg (match val = 17495704.0)")
    assert str(e) == "Dials not found from file: x.jpg (match val = 17495704.0)"


def test_zero_match_val_renders_as_0_0():
    e = DialsNotFoundError("x.jpg", extra_info={"match val": 0.0})
    assert e.get_message() == "Dials not found (match val = 0.0)"


def test_needle_contours_message():
    e = NeedleContoursNotFoundError(extra_info={"dial": "0.0001"})
    assert e.get_message() == (
        "Cannot find needle contours of a dial (dial = 0.0001)")


def test_dial_angle_message():
    e = DialAngleDeterminingError(
        "f.jpg", extra_info={"unreadable dials": "0.001, 0.01"})
    assert e.get_message() == (
        "Cannot determine angle of a dial (unreadable dials = 0.001, 0.01)")


def test_loading_error_is_ioerror():
    e = ImageLoadingError("f.jpg")
    assert isinstance(e, IOError)
    assert e.get_message() == "Unable to load image"


def test_error_class_registry():
    """Graph error codes map to their host exception classes."""
    from meterelf_jax.errors import ErrCode, error_class_for

    assert error_class_for(ErrCode.LOAD) is ImageLoadingError
    assert error_class_for(int(ErrCode.DIALS_NOT_FOUND)) is DialsNotFoundError
    assert error_class_for(ErrCode.NEEDLE_CONTOURS) is (
        NeedleContoursNotFoundError)
    assert error_class_for(ErrCode.DIAL_ANGLE) is DialAngleDeterminingError


def test_empty_extra_info_renders_no_suffix():
    e = DialsNotFoundError("x.jpg", extra_info={})
    assert e.get_message() == "Dials not found"
    e2 = DialsNotFoundError("x.jpg")
    assert e2.get_message(with_extra_info=False) == "Dials not found"
