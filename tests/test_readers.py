"""The dependency-free readers against the packages they replace: the
params YAML reader against PyYAML, the template PNG reader against
Pillow (both test-only oracles)."""
import glob
import os

import numpy as np
import pytest

from meterelf_jax import minyaml
from meterelf_jax.io.png import PngError, read_png_gray, write_png_gray

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "synthetic")

DOCS = {
    "block_and_flow": """\
# leading comment
image_glob: "*.jpg"   # trailing comment
meter_rect:
  top_left: [50, 160]
  bottom_right: [ 300 , 410 ]
threshold: 20000000
ratio: -4.5
big: 1.5e+6
flag_a: true
flag_b: no
flag_c: On
nothing: ~
empty:
quoted: 'it''s # not a comment'
dq: "a \\"b\\" c"
plain: some words here
needle_data:
- name: '0.0001'
  color_range: {h: 15, l: 60, s: 80}
  center: [37.3, 63.4]
  negative_momentum: false
-   name: "0.1"
    center: [160.9, 36.5]
    diameter: 12
""",
    "nested_sequences": """\
outer:
  - 1
  -
    - 2
    - 3
  -
    key: value
  - [4, 'five', 6.0]
numbers:
  -
    - 7
top: .inf
neg: -.inf
""",
    "scalars_as_strings": """\
version: 1.2.3
ip: 10.0.0.1
exp_no_dot: 1e5
dash: a-b
""",
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_yaml_reader_matches_pyyaml(name):
    yaml = pytest.importorskip("yaml")
    want = yaml.safe_load(DOCS[name])
    assert minyaml.safe_load(DOCS[name]) == want


@pytest.mark.parametrize("camera", ["default", "alt"])
def test_yaml_reader_matches_pyyaml_on_fixture_params(camera):
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(FIXTURES, camera, "params.yml")) as fp:
        text = fp.read()
    assert minyaml.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("doc", [
    "a: &anchor 1\nb: *anchor\n",          # anchors and aliases
    "a: !!str 5\n",                        # tags
    "a: |\n  block text\n",                # block scalars
    "---\na: 1\n",                         # document markers
    "a: [1, [2, 3]]\n",                    # nested flow collections
    "a: 1\n  b: 2\n",                      # bad indentation
    "a: 1\na: 2\n",                        # duplicate keys
    "a: 'open\n",                          # unterminated string
    "t: 12:30\n",                          # YAML 1.1 sexagesimal
    "h: 0x1f\n",                           # hex
    "o: 010\n",                            # octal
    "a:\n  - - 1\n",                        # compact nested sequence
])
def test_yaml_reader_rejects_unsupported(doc):
    with pytest.raises(minyaml.YamlError):
        minyaml.safe_load(doc)


def test_params_load_error_on_unsupported_yaml(tmp_path):
    from meterelf_jax.params import LoadError, Params

    p = tmp_path / "params.yml"
    p.write_text("image_glob: &g '*.jpg'\n")
    with pytest.raises(LoadError, match="Cannot load YAML data"):
        Params.load(str(p))


def _pillow_png(tmp_path, mode, arr, palette=None):
    Image = pytest.importorskip("PIL.Image")
    img = Image.fromarray(arr, mode)
    if palette is not None:
        img.putpalette(palette)
    path = str(tmp_path / f"{mode}.png")
    img.save(path)
    return path, np.asarray(img.convert("L"))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_reader_matches_pillow(tmp_path, mode):
    """Every colour type the reader takes, against Pillow's convert("L");
    smooth and noisy content so Pillow's encoder picks several filter
    types."""
    rng = np.random.default_rng(sum(map(ord, mode)))
    h, w = 37, 53
    y, x = np.mgrid[0:h, 0:w]
    smooth = (x * 4 + y * 3) % 256
    chans = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    arr = np.stack([(smooth + 50 * c + rng.integers(0, 9, (h, w))) % 256
                    for c in range(chans)], -1).astype(np.uint8)
    palette = None
    if mode == "P":
        arr = (arr[..., 0] % 200).astype(np.uint8)
        palette = rng.integers(0, 256, 600).tolist()
    elif chans == 1:
        arr = arr[..., 0]
    path, want = _pillow_png(tmp_path, mode, arr, palette)
    np.testing.assert_array_equal(read_png_gray(path), want)


def test_png_writer_roundtrip_and_fixture_templates(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    arr = np.random.default_rng(5).integers(0, 256, (19, 23)).astype(
        np.uint8)
    path = str(tmp_path / "w.png")
    write_png_gray(path, arr)
    np.testing.assert_array_equal(read_png_gray(path), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    for png in glob.glob(os.path.join(FIXTURES, "*", "*.png")):
        np.testing.assert_array_equal(
            read_png_gray(png), np.asarray(Image.open(png).convert("L")))


def test_png_reader_rejects_unsupported(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "i16.png")
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(path)
    with pytest.raises(PngError):
        read_png_gray(path)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(PngError):
        read_png_gray(str(bad))
