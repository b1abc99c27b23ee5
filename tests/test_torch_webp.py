"""The port's WebP decoder (``csrc/webpdec.cpp`` through ``data/codec.py``)
against Pillow, on the CPU: bit-equal, with no tolerance.

- Every committed fixture (``tests/torch_fixtures/webp/``: lossy with the
  normal, simple and no loop filter, 1/2/4/8 token partitions, one or four
  segments, a sharpness; lossless with every transform, pixel bundling, the
  color cache and meta prefix codes; alpha raw and VP8L-compressed under
  each filter; animations, one whose first frame covers part of the
  canvas; 1x1, 17x13 and 67x45 images) decodes through ``decode_rgb`` to
  ``np.asarray(Image.open(p).convert("RGB"))`` and to its manifest sha256,
  its RGBA to Pillow's ``convert("RGBA")``; the manifest regenerated here
  equals the committed one, and the fixtures together exercise every part
  of the format the decoder reports.
- Images Pillow encodes here at drawn sizes and settings decode equal.
- Truncated and corrupt files: a cut file, a RIFF size past the end, a bad
  VP8L signature or version, a VP8 inter frame, a corrupt ALPH header are
  refused with a ``ValueError`` naming the file (Pillow refuses each too);
  bit flips and cuts of every fixture either decode equal to Pillow or are
  refused by both. The committed ``corrupt_y2_overflow.webp`` (three bit
  flips of a lossy fixture's frame header: an all-ones token partition, a
  Y2 DC past 16 bits, and libwebp's branch-free sign read parting from a
  plain boolean read) decodes to Pillow's garbage.
- A WebP file under a ``.png`` name in an ``ImageFolderFlat``: batches
  equal to the reference loader's, which sniffs the format with Pillow.
"""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from gan_lib_tensorflow_tpu_torch import data
from gan_lib_tensorflow_tpu_torch.data import codec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "webp")
sys.path.insert(0, FIXTURES)
import make_fixtures  # noqa: E402

MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))
FILES = sorted(MANIFEST["files"])


def _pillow(path, mode="RGB"):
    with Image.open(path) as img:
        return np.asarray(img.convert(mode))


@pytest.mark.parametrize("name", FILES)
def test_fixture_decodes_as_pillow_and_its_manifest(name):
    path = os.path.join(FIXTURES, name)
    entry = MANIFEST["files"][name]
    got = codec.decode_rgb(path)
    want = _pillow(path)
    assert got.dtype == np.uint8 and list(got.shape) == entry["shape"]
    np.testing.assert_array_equal(got, want)
    assert make_fixtures.digest(got) == entry["rgb_sha256"]
    rgba = codec.decode_webp_rgba(path)
    np.testing.assert_array_equal(rgba, _pillow(path, "RGBA"))
    assert make_fixtures.digest(rgba) == entry["rgba_sha256"]
    assert codec.webp_features(path) == entry["features"]


def test_committed_manifest_is_pillows():
    assert make_fixtures.manifest(FILES) == MANIFEST


def test_fixtures_cover_the_format():
    feats = [MANIFEST["files"][name]["features"] for name in FILES]
    union = lambda key: int(np.bitwise_or.reduce([f[key] for f in feats]))
    # VP8L: the four transforms, color cache, meta codes, simple and normal
    # prefix codes, backward references, pixel bundling
    assert union("lossless") == 0x3ff
    # predictor tiles of modes 1-13 (mode 0 predicts each image's first pixel)
    assert union("predictors") == 0x3ffe
    assert {f["filter"] for f in feats} == {0, 1, 2}  # none, simple, normal
    assert {f["partitions"] for f in feats} == {0, 1, 2, 4, 8}  # 0: lossless files
    assert {f["segments"] for f in feats} == {0, 1}
    assert max(f["sharpness"] for f in feats) > 0
    # ALPH: raw, and VP8L under no, horizontal, vertical and gradient filters
    assert {f["alpha"] for f in feats} == {0, 0x01, 0x02, 0x12, 0x22, 0x32}
    assert union("flags") == 0x1f  # animation, VP8X, 4x4 and 16x16 modes, skips
    offset = MANIFEST["files"]["animation_offset_frame.webp"]
    assert offset["features"]["flags"] & 1
    rgba = codec.decode_webp_rgba(os.path.join(FIXTURES, "animation_offset_frame.webp"))
    assert not rgba[:6].any() and not rgba[:, :10].any()  # the canvas left at (0,0,0,0)
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in FILES) < 200_000


CASES = [((1, 2), dict(quality=50)), ((3, 1), dict(lossless=True)),
         ((16, 16), dict(quality=0, method=0)), ((31, 47), dict(quality=100, method=6)),
         ((33, 18), dict(quality=85, method=3)), ((48, 80), dict(lossless=True, method=0)),
         ((29, 35), dict(lossless=True, quality=100, method=5)),
         ((40, 24), dict(quality=60, alpha=True)), ((24, 40), dict(lossless=True, alpha=True)),
         ((57, 23), dict(palette=6)), ((23, 57), dict(palette=40))]


@pytest.mark.parametrize("shape,kw", CASES, ids=[f"{s[0]}x{s[1]}-{sorted(k)}" for s, k in CASES])
def test_pillow_encodes_decode_bit_equal(shape, kw, tmp_path):
    kw = dict(kw)
    h, w = shape
    img = Image.fromarray(make_fixtures.photo(h, w, h * 100 + w))
    if kw.pop("alpha", False):
        img = Image.fromarray(np.dstack([np.asarray(img), make_fixtures.alpha_plane(h, w, "rings")]),
                              "RGBA")
    if "palette" in kw:
        img = img.quantize(kw.pop("palette")).convert("RGB")
        kw["lossless"] = True
    path = str(tmp_path / "x.webp")
    img.save(path, "WEBP", **kw)
    np.testing.assert_array_equal(codec.decode_rgb(path), _pillow(path))
    np.testing.assert_array_equal(codec.decode_webp_rgba(path), _pillow(path, "RGBA"))


def _refused_by_both(path, match):
    with pytest.raises(ValueError, match=match) as e:
        codec.decode_rgb(path)
    assert path in str(e.value)
    with pytest.raises(Exception):
        _pillow(path)


def _patched(name, tmp_path, edit):
    data_ = bytearray(open(os.path.join(FIXTURES, name), "rb").read())
    edit(data_)
    path = str(tmp_path / f"bad_{name}")
    with open(path, "wb") as f:
        f.write(bytes(data_))
    return path


def test_truncated_and_corrupt_files_refuse_by_name(tmp_path):
    full = open(os.path.join(FIXTURES, "lossy_17x13.webp"), "rb").read()
    for cut in (4, 11, 12, 20, 30, len(full) // 2, len(full) - 1):
        path = str(tmp_path / f"cut{cut}.webp")
        with open(path, "wb") as f:
            f.write(full[:cut])
        _refused_by_both(path, "WebP|VP8")

    def riff_size(d):
        d[4:8] = (len(d) + 100).to_bytes(4, "little")
    _refused_by_both(_patched("lossless_1x1.webp", tmp_path, riff_size), "truncated WebP")

    def signature(d):
        d[20] = 0x2e  # the VP8L signature byte
    _refused_by_both(_patched("lossless_1x1.webp", tmp_path, signature), "VP8L")

    def version(d):
        d[24] |= 0x20  # a version bit
    _refused_by_both(_patched("lossless_1x1.webp", tmp_path, version), "VP8L")

    def inter_frame(d):
        d[20] |= 1  # the frame tag's key-frame bit says an inter frame
    _refused_by_both(_patched("lossy_17x13.webp", tmp_path, inter_frame), "key frame")

    def alpha_method(d):
        d[38] = (d[38] & ~3) | 3  # ALPH compression 3 does not exist
    path = _patched("alpha_uncompressed.webp", tmp_path, alpha_method)
    assert open(path, "rb").read()[30:34] == b"ALPH"
    _refused_by_both(path, "ALPH")
    path = str(tmp_path / "not.webp")
    with open(path, "wb") as f:
        f.write(b"RIFF\x10\0\0\0WEBPVP8 " + bytes(8))  # an empty VP8 chunk, then 4 bytes
    _refused_by_both(path, "VP8")


@pytest.mark.parametrize("name", FILES)
def test_corrupted_fixtures_decode_as_pillow_or_are_refused_by_both(name, tmp_path):
    """Bit flips past the file header and cuts (with the RIFF size mended)
    of each fixture: Pillow's decode and the port's are equal, or both
    refuse the file."""
    full = open(os.path.join(FIXTURES, name), "rb").read()
    rng = np.random.default_rng(sum(full[:64]))
    variants = []
    for _ in range(4):
        d = bytearray(full)
        i = int(rng.integers(min(30, len(d) - 1), len(d)))
        d[i] ^= 1 << int(rng.integers(0, 8))
        variants.append(bytes(d))
    for _ in range(2):
        n = int(rng.integers(20, len(full))) if len(full) > 21 else len(full)
        d = bytearray(full[:n])
        d[4:8] = (n - 8).to_bytes(4, "little")
        variants.append(bytes(d))
    path = str(tmp_path / "v.webp")
    for d in variants:
        with open(path, "wb") as f:
            f.write(d)
        try:
            want = _pillow(path, "RGBA")
        except Exception:
            want = None
        if want is None:
            with pytest.raises(ValueError, match="v.webp"):
                codec.decode_webp_rgba(path)
        else:
            np.testing.assert_array_equal(codec.decode_webp_rgba(path), want)


def test_the_corrupt_y2_fixture_is_three_flips_that_decode_to_pillows_garbage():
    path = os.path.join(FIXTURES, "corrupt_y2_overflow.webp")
    bad = open(path, "rb").read()
    clean = open(os.path.join(FIXTURES, "lossy_partitions2.webp"), "rb").read()
    assert len(bad) == len(clean)
    assert sum(bin(a ^ b).count("1") for a, b in zip(bad, clean)) == 3
    want = _pillow(path, "RGBA")
    assert not np.array_equal(want, _pillow(os.path.join(FIXTURES, "lossy_partitions2.webp"),
                                            "RGBA"))
    np.testing.assert_array_equal(codec.decode_webp_rgba(path), want)


def test_webp_under_a_png_name_in_an_image_folder(tmp_path):
    """The reference loaders open files by extension and decode by content
    (Pillow): a WebP named ``.png`` is read as WebP by both."""
    from gan_lib_tensorflow_tpu import data as jdata
    folder = tmp_path / "flat"
    folder.mkdir()
    for i, name in enumerate(["lossy_q95_m6_67x45.webp", "lossless_rgba_exact1.webp",
                              "palette16.webp"]):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            (folder / f"w{i}.png").write_bytes(f.read())
    Image.fromarray(make_fixtures.photo(40, 52, 3)).save(folder / "j.jpg", quality=90)
    kw = dict(batch_size=2, image_size=24, seed=4)
    ref, port = jdata.ImageFolderFlat(str(folder), **kw), data.ImageFolderFlat(str(folder), **kw)
    assert port.files == ref.files
    it_ref, it_port = iter(ref), iter(port)
    for _ in range(4):
        got, want = next(it_port), next(it_ref)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
