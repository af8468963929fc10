"""What the program needs from its host: the compile-cache placement,
the native decoder's build key, the CLI without PyYAML and Pillow, and
chip_smoke.py refusing to run without a GPU."""
import contextlib
import io
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "synthetic")


def test_compile_cache_uses_the_environment_when_set(monkeypatch):
    import jax

    from meterelf_jax.compile_cache import setup_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/shared/cache")
    assert setup_compile_cache() == "/some/shared/cache"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    import jax

    from meterelf_jax.compile_cache import DEFAULT_DIR, setup_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert setup_compile_cache() == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == DEFAULT_DIR
        assert setup_compile_cache() == DEFAULT_DIR    # fixed, not per run
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_build_key_tracks_source_flags_and_cpu(monkeypatch):
    """The library's name changes with the source, the build arguments
    and the CPU, so a library built elsewhere is never loaded."""
    from meterelf_jax.io.native import build

    args = ["gcc", "-O3", "-march=native"]
    key = build.build_key(args)
    assert key == build.build_key(list(args))
    assert key != build.build_key(args + ["-DX"])
    monkeypatch.setattr(build, "_cpu_signature", lambda: "model name: other")
    assert build.build_key(args) != key
    real = build.SRC
    monkeypatch.setattr(build, "_cpu_signature", lambda: "")
    k0 = build.build_key(args)
    monkeypatch.setattr(build, "SRC", os.path.join(
        REPO, "tests", "data", "synthetic", "default", "params.yml"))
    assert build.build_key(args) != k0
    monkeypatch.setattr(build, "SRC", real)
    path = build.ensure_built()
    assert os.path.basename(path).startswith("_meterelf_jpeg-")
    assert os.path.dirname(path) == build.BUILD_DIR
    assert build.build_key(build._build_args()) in path


@pytest.mark.parametrize("camera", ["default", "alt"])
def test_cli_without_pyyaml_and_pillow(camera, monkeypatch):
    """The reference CLI path on the committed corpus, with yaml and PIL
    made unimportable, prints the committed expected output."""
    from meterelf_jax import cli

    for mod in ("yaml", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    d = os.path.join(FIXTURES, camera)
    frames = sorted(f for f in os.listdir(d) if f.endswith(".jpg"))
    monkeypatch.chdir(d)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["meterelf", "params.yml"] + frames)
    with open("expected_stdout.txt") as fp:
        assert buf.getvalue() == fp.read()


def test_chip_smoke_refuses_cpu_only_hosts():
    """Without a GPU, chip_smoke.py exits non-zero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr
