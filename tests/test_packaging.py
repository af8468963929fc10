"""Packaging gate: the reference ships an executable packaging check
(/root/reference/check-packaging:1-20, tox env `packaging`,
/root/reference/tox.ini:2). This is its analog: build a wheel from the
repo, install it into an isolated target dir, and prove a clean-process
import compiles the native decoder and decodes a real frame — i.e.
`pip install meterelf-jax` + first use works, including the .c
package-data path.
"""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = "/root/reference/sample-images1/20180814021357-00-e01.jpg"


@pytest.fixture(scope="module")
def installed_pkg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pkg")
    wheels = tmp / "wheels"
    site = tmp / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", REPO, "--no-deps",
         "--no-build-isolation", "-w", str(wheels)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    whls = list(wheels.glob("meterelf_jax-*.whl"))
    assert len(whls) == 1, whls
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", str(whls[0]),
         "--no-deps", "--target", str(site)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return site


def _run_in_site(site, code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(site), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=300, cwd=str(site),
        env=env)


def test_wheel_import_and_native_decode(installed_pkg):
    """Clean-process import from the installed wheel; the native .c
    (shipped as package data) compiles on first use and decodes a real
    corpus frame byte-for-byte (self-check runs at lib load)."""
    if not os.path.exists(SAMPLE):
        pytest.skip("sample corpus not mounted")
    r = _run_in_site(installed_pkg, f"""
        import meterelf_jax
        assert "pkg" in meterelf_jax.__file__, meterelf_jax.__file__
        from meterelf_jax.io.jpeg import decode_file
        img = decode_file({SAMPLE!r})
        assert img is not None and img.shape[2] == 3, img
        from meterelf_jax.params import Params
        p = Params.load("/root/reference/sample-images1/params.yml")
        assert p.meter_rect.width > 0
        print("OK", img.shape)
    """)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    assert r.stdout.startswith("OK")


def test_wheel_cli_entry(installed_pkg):
    """The installed package's CLI module prints usage and exits 1 with
    no arguments (meterelf/_main.py:10 semantics)."""
    env = dict(os.environ, PYTHONPATH=str(installed_pkg),
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "meterelf_jax"],
        capture_output=True, text=True, timeout=120,
        cwd=str(installed_pkg), env=env)
    assert r.returncode == 1
    assert "Usage" in r.stderr or "usage" in r.stderr
