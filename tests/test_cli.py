"""CLI behavior parity: debug-mode output dict, debug-mode re-raise,
module wiring, usage error (reference: tests/test_meterelf.py:147-188 and
tests/test_main.py)."""
import io
import json
import contextlib
import runpy
import sys
from unittest.mock import patch

import pytest

import meterelf_jax
from meterelf_jax import cli, debugging

pytestmark = pytest.mark.needs_samples

SAMPLE1 = "/root/reference/sample-images1"
PARAMS = f"{SAMPLE1}/params.yml"


def run_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def test_usage_error():
    with pytest.raises(SystemExit, match="Usage"):
        cli.main(["meterelf"])


def test_debug_output_dict():
    """Debug-mode stdout dict (reference test_output_in_debug_mode)."""
    path = f"{SAMPLE1}/20180814215230-01-e136.jpg"
    with patch.object(debugging, "DEBUG", new={"1"}):
        out = run_main(["meterelf", PARAMS, path])
    basic = path + ": 253.623"
    assert out.startswith(basic)
    data = json.loads(out[len(basic):].replace("'", '"').strip())
    assert set(data) == {"0.0001", "0.001", "0.01", "0.1", "value"}
    assert abs(data["0.0001"] - 6.23) < 0.005
    assert abs(data["0.001"] - 3.3) < 0.05
    assert abs(data["0.01"] - 5.1) < 0.05
    assert abs(data["0.1"] - 2.4) < 0.05
    assert abs(data["value"] - 253.62306) < 0.000005


@pytest.mark.parametrize("filename,msg", [
    ("20180814021309-01-e01.jpg", "Dials not found (match val = 0.0)"),
    ("20180814021310-00-e02.jpg", "Dials not found (match val = 17495704.0)"),
])
def test_debug_reraises_with_exact_message(capsys, filename, msg):
    path = f"{SAMPLE1}/{filename}"
    with patch.object(debugging, "DEBUG", new={"1"}):
        with pytest.raises(Exception) as excinfo:
            cli.main(["meterelf", PARAMS, path])
    assert excinfo.value.get_message() == msg
    captured = capsys.readouterr()
    assert captured.out == ""


def test_run_as_module():
    with patch.object(cli, "main") as main_mock:
        sys.modules.pop("meterelf_jax.__main__", None)
        runpy.run_module(meterelf_jax.__name__, run_name="__main__")
        main_mock.assert_called_with()


def test_value_zero_prints_empty():
    """The reference's `if data.value` quirk: a 0.000 reading prints as
    an empty value (meterelf/_main.py:17) — asserted on the REAL
    formatting path (cli.format_result), not a re-implementation."""
    from meterelf_jax.api import MeterImageData

    zero = MeterImageData("f.jpg", 0.0, None, {"value": 0.0})
    assert cli.format_result(zero) == "f.jpg: "
    nonzero = MeterImageData("f.jpg", 253.623, None, {"value": 253.623})
    assert cli.format_result(nonzero) == "f.jpg: 253.623"
    small = MeterImageData("f.jpg", 0.062, None, {"value": 0.062})
    assert cli.format_result(small) == "f.jpg: 000.062"
