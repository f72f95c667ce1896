"""The port's JPEG decoder on every kind PIL reads beyond one baseline
scan, on the CPU, against PIL through the JAX package.

``load_gray_image(..., device="cpu")`` runs both plain twins (the Python
entropy decoder and J1's PyTorch twin); it must equal the JAX package's
``load_gray_image`` bit for bit and ``read_jpeg(..., 3)`` PIL's
``convert("RGB")`` on: progressive streams (PIL's ``progressive=True``:
grey, 4:4:4, 4:2:2, 4:2:0 at qualities 50, 75 and 95, restart markers,
odd and tiny sizes, CMYK), Adobe CMYK and YCCK (every Adobe transform,
and none), 4:1:1 and 4:4:0 (a PIL file's SOF relabelled), and sequential
streams in several scans or with other sampling factors, written by the
fixture script's coefficient-level encoder (``write_sequential``). A
progressive stream's coefficients equal the baseline stream's of the same
pixels; a DQT after a component's first scan does not apply to it; a
stream whose last refinement scans are missing is block-smoothed as PIL
reads it; and what stays refused raises a ``ValueError`` naming it.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from superviseddescent_tpu_torch.io import jpeg
from superviseddescent_tpu_torch.ops.jpeg import read_jpeg
from test_torch_jpeg import check_against_pil, image
from torch_jpeg_fixtures import OUT as FIXTURES
from torch_jpeg_fixtures import encode, reencode, tint, write_sequential

KINDS = ("grey", "4:4:4", "4:2:2", "4:2:0")


def save(path, data):
    path.write_bytes(data)
    return path


def cmyk(pixels, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).convert("CMYK").save(buf, "JPEG", **options)
    return buf.getvalue()


def adobe_transform(data: bytes, transform) -> bytes:
    """The stream with its Adobe APP14 transform set, or the segment
    dropped (``None``)."""
    at = data.index(b"\xff\xee\x00\x0eAdobe")
    if transform is None:
        return data[:at] + data[at + 16:]
    data = bytearray(data)
    data[at + 4 + 11] = transform
    return bytes(data)


def relabel(data: bytes, offset: int, value: int) -> bytes:
    """One byte of the SOF (SOF0 or SOF2) segment set to ``value``."""
    data = bytearray(data)
    sof = data.index(b"\xff\xc0") if b"\xff\xc0" in data else data.index(
        b"\xff\xc2")
    data[sof + offset] = value
    return bytes(data)


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("kind", KINDS)
def test_progressive_equals_jax(tmp_path, kind, quality):
    data = encode(image((61, 83), quality, kind), kind, quality,
                  progressive=True)
    assert jpeg.parse_jpeg(data).progressive
    check_against_pil(save(tmp_path / "img.jpg", data))


@pytest.mark.parametrize("kind,shape,options", [
    ("4:2:0", (77, 95), {"restart_marker_rows": 1}),
    ("grey", (40, 57), {"restart_marker_blocks": 3}),
    ("4:2:2", (64, 48), {"restart_marker_blocks": 5, "optimize": True}),
    ("4:2:0", (1, 1), {}), ("4:2:0", (3, 4), {}), ("4:2:2", (5, 3), {}),
    ("grey", (1, 9), {}), ("4:4:4", (17, 33), {}),
])
def test_progressive_variants_equal_jax(tmp_path, kind, shape, options):
    data = encode(image(shape, sum(shape), kind), kind, 75,
                  progressive=True, **options)
    check_against_pil(save(tmp_path / "img.jpg", data))


@pytest.mark.parametrize("transform", [None, 0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_and_ycck_equal_jax(tmp_path, transform, progressive):
    """PIL reads four components inverted (``CMYK;I``) with or without an
    Adobe marker; libjpeg takes any transform but 0 for YCCK."""
    data = adobe_transform(cmyk(tint(image((37, 45), 4, "grey"), 4),
                                quality=80, progressive=progressive),
                           transform)
    f = jpeg.parse_jpeg(data)
    assert f.color == (jpeg.COLOR_YCCK if transform else jpeg.COLOR_CMYK)
    check_against_pil(save(tmp_path / "img.jpg", data))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("pil_kind,luma,up", [
    ("4:2:0", 0x41, jpeg.UP_BOX), ("4:2:2", 0x12, jpeg.UP_H1V2)])
def test_relabelled_411_and_440_equal_jax(tmp_path, pil_kind, luma, up,
                                         progressive):
    """4:1:1 (luma 4x1: replication by 4) and 4:4:0 (luma 1x2: libjpeg's
    h1v2 triangle filter): PIL's 4:2:0 and 4:2:2 streams with the luma's
    sampling relabelled, which keeps the blocks per MCU and the MCUs."""
    data = relabel(encode(image((48, 96), 11, pil_kind), pil_kind, 85,
                          progressive=progressive), 11, luma)
    f = jpeg.parse_jpeg(data)
    assert [c.up for c in f.components[1:]] == [up, up]
    check_against_pil(save(tmp_path / "img.jpg", data))


@pytest.mark.parametrize("sampling,scans,restart", [
    (((2, 2), (1, 1), (1, 1)), [[0], [1], [2]], 0),
    (((2, 1), (1, 1), (1, 1)), [[0], [1, 2]], 3),
    (((2, 2), (1, 1), (1, 1)), [[2], [0], [1]], 0),
    (((1, 1), (1, 1), (1, 1)), [[0, 1], [2]], 2),
    (((1, 1), (2, 2), (2, 2)), [[0, 1, 2]], 0),
    (((3, 1), (1, 1), (1, 1)), [[0, 1, 2]], 0),
    (((2, 2), (1, 2), (2, 1)), [[0, 1, 2]], 4),
    (((1, 4), (1, 2), (1, 1)), [[0, 1, 2]], 0),
    (((4, 4), (2, 1), (1, 4)), [[0], [1], [2]], 7),
    (((3, 3), (1, 1), (3, 1)), [[0], [1, 2]], 0),
])
def test_reencoded_scans_and_sampling_equal_jax(tmp_path, sampling, scans,
                                                restart):
    """Sequential streams in several scans (any order, any subset, restart
    markers) and sampling factors PIL cannot write: luma upsampled under
    larger chroma, replication by 3 and 4, h1v2 and h2v1 in one image,
    16 blocks of one component in scans of their own."""
    pixels = tint(image((45, 67), 3, "grey"), 3)
    data = reencode(pixels, sampling, scans, restart)
    f = jpeg.parse_jpeg(data)
    assert [s.comps for s in f.scans] == scans
    check_against_pil(save(tmp_path / "img.jpg", data))


def test_grey_in_one_scan_of_a_stream_of_standard_tables(tmp_path):
    """A stream with no DHT (motion-JPEG frames) takes the standard tables
    that libjpeg-turbo installs, as PIL does."""
    data = encode(image((30, 41), 2, "4:2:0"), "4:2:0", 80)
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != jpeg.SOS:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != jpeg.DHT:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    out += data[pos:]
    check_against_pil(save(tmp_path / "img.jpg", bytes(out)))


def test_quantisation_tables_latch_at_the_first_scan(tmp_path):
    """libjpeg fixes a component's table when its first scan starts: a DQT
    that redefines table 1 after Cb's scan applies to Cr, not to Cb."""
    src = jpeg.parse_jpeg(encode(tint(image((40, 48), 6, "grey"), 6),
                                 "4:4:4", 70))
    coef = jpeg.entropy_decode(src)
    q = {0: src.components[0].quant, 1: src.components[1].quant}
    later = {1: np.clip(q[1] * 2, 1, 255)}
    data = write_sequential(48, 40, ((1, 1),) * 3, q, coef,
                            [[0], [1], [2]], dqt_before={2: later})
    f = jpeg.parse_jpeg(data)
    np.testing.assert_array_equal(f.components[1].quant, q[1])
    np.testing.assert_array_equal(f.components[2].quant, later[1])
    path = save(tmp_path / "img.jpg", data)
    check_against_pil(path)
    # the table in force at the end, for both, gives other pixels
    f.components[1].quant = later[1]
    assert not torch.equal(
        jpeg.pixels_reference(torch.from_numpy(coef), f, 3),
        read_jpeg(path, 3, device="cpu"))


def test_full_size_progressive_still_equals_jax():
    check_against_pil(os.path.join(FIXTURES, "p03_420_q75_prog.jpg"))


def test_progressive_coefficients_equal_baseline():
    """Progressive coding changes how the quantised coefficients are
    coded, not their values: a progressive still and the baseline still
    of the same pixels give the same coefficients, and so does each
    checked frame of the progressive clip."""
    pairs = [("p03_420_q75_prog.jpg", "s03_420_q75.jpg"),
             ("p00_grey_q75_prog.jpg", "s00_grey_q75.jpg")] + [
        (f"clip_progressive/f{k:03d}.jpg", f"clip/f{k:03d}.jpg")
        for k in (0, 15)]
    for prog, base in pairs:
        fp, fb = (jpeg.parse_jpeg(open(os.path.join(FIXTURES, n), "rb")
                                  .read()) for n in (prog, base))
        assert fp.progressive and not fb.progressive
        want = jpeg.entropy_decode(fb)
        got = jpeg.entropy_decode(fp)
        # the padding blocks of the MCU grid are coded only by
        # interleaved scans: compare the blocks inside the image
        for c in fb.components:
            grid = np.s_[c.offset:c.offset + c.nbx * c.nby]
            inside = (slice(0, c.bh), slice(0, c.bw))
            np.testing.assert_array_equal(
                got[grid].reshape(c.nby, c.nbx, 64)[inside],
                want[grid].reshape(c.nby, c.nbx, 64)[inside])


def test_fixture_progressive_clip_matches_manifest():
    from test_torch_jpeg import digest, manifest
    clip = manifest()["clip_progressive"]
    base = manifest()["clip"]
    assert len(clip["frames"]) == len(base["frames"])
    assert clip["offsets"] == base["offsets"]
    for frame, same in zip(clip["frames"], base["frames"]):
        assert frame["grey_sha256"] == same["grey_sha256"]
    for frame in clip["frames"][:4]:
        grey = read_jpeg(os.path.join(FIXTURES, frame["name"]), 1,
                         device="cpu")
        assert list(grey.shape) == frame["shape"] == [1024, 768]
        assert digest(grey) == frame["grey_sha256"]


def progressive_scans(data):
    """(offset of each SOS marker, end of its entropy-coded data)."""
    out, pos = [], 0
    while True:
        pos = data.find(b"\xff\xda", pos)
        if pos < 0:
            return out
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((pos, jpeg._scan_end(data, pos + 2 + length)))
        pos += 2


def sos_patched(data, scan, offset_from_end, value):
    """A byte of the ``scan``-th SOS header, counted from its end (1: Ah /
    Al, 2: Se, 3: Ss)."""
    data = bytearray(data)
    pos = progressive_scans(bytes(data))[scan][0]
    length = int.from_bytes(data[pos + 2:pos + 4], "big")
    data[pos + 2 + length - offset_from_end] = value
    return bytes(data)


def without_scans(data, drop):
    """The stream without the scans (and the tables just before them)
    whose indices are in ``drop``."""
    scans = progressive_scans(data)
    out, pos = bytearray(), 0
    for k, (start, end) in enumerate(scans):
        if k in drop:
            out += data[pos:start]
            pos = end
    return bytes(out + data[pos:])


def progressive_refusal_cases():
    # PIL's scans for YCbCr: 0 DC first (Al 1), 1 Y 1-5, 2 Cr 1-63, 3 Cb
    # 1-63, 4 Y 6-63, 5 Y refine 1-63 (Ah 2, Al 1), 6 DC refine (Ah 1,
    # Al 0), 7 Cr refine, 8 Cb refine, 9 Y refine (Ah 1, Al 0)
    prog = encode(image((32, 48), 8, "4:2:0"), "4:2:0", 75,
                  progressive=True)
    colour = encode(image((32, 32), 3, "4:2:0"), "4:2:0", 75)
    sos = b"\xff\xda\x00\x0c\x03\x01\x00\x02\x11"    # Y 0/0, Cb 1/1
    seq = reencode(tint(image((24, 32), 2, "grey"), 2),
                   ((2, 2), (1, 1), (1, 1)), [[0], [1], [2]])
    start, end = progressive_scans(seq)[2]
    pos = progressive_scans(prog)[1][0]                 # Y 1-5, Al 2
    two_sos = (prog[:pos] + b"\xff\xda\x00\x0a\x02\x01\x00\x02\x00"
               + bytes([1, 5, 0x02]) + prog[pos + 10:])
    # the first case was refused until libjpeg's block smoothing came in:
    # its bytes now read as PIL reads them (message None)
    return {
        "incomplete refinement": (without_scans(prog, {7, 8, 9}), None),
        "fractional sampling": (
            relabel(relabel(colour, 11, 0x31), 14, 0x21),
            "fractional sampling not implemented"),
        "dc scan with se": (sos_patched(prog, 0, 2, 5),
                            "a DC scan with Se=5"),
        "ac scan with ss above se": (sos_patched(prog, 1, 3, 6),
                                     "an AC scan with Ss=6, Se=5"),
        "ac scan of two components": (two_sos,
                                      "an AC scan of 2 components"),
        "ah without al = ah - 1": (sos_patched(prog, 5, 1, 0x20),
                                   "a refinement with Ah=2, Al=0"),
        "al above 13": (sos_patched(prog, 0, 1, 14), "Al=14"),
        "refinement out of order": (
            sos_patched(prog, 6, 1, 0x21), "Ah=2 but the last scan left "
            "Al=1"),
        "ac before dc": (without_scans(prog, {0}),
                         "an AC scan of component 0 before its first DC"),
        "sequential scan of a band": (sos_patched(colour, 0, 2, 5),
                                      "in a sequential frame"),
        "component without a scan": (seq[:start] + seq[end:],
                                     "component 2 \\(id 3\\) has no scan"),
        "component in two sequential scans": (
            seq[:end] + seq[start:end] + seq[end:],
            "a component in two scans of a sequential frame"),
        "sampling factor 5": (relabel(colour, 11, 0x52), "1 to 4 only"),
        "more than 10 blocks an mcu": (relabel(colour, 11, 0x44),
                                       "more than 10 blocks in an MCU"),
        "component id not in the frame": (
            colour.replace(sos, sos[:5] + b"\x07" + sos[6:]),
            "component id 7 is not in the frame"),
        "components out of frame order": (
            colour.replace(sos, sos[:5] + b"\x02\x11\x01\x00" + sos[9:]),
            "components out of frame order"),
        "component twice in a scan": (
            colour.replace(sos, sos[:7] + b"\x01" + sos[8:]),
            "component id 1 twice in a scan"),
    }


@pytest.mark.parametrize("case", sorted(progressive_refusal_cases()))
def test_refusals_name_what_stays_unsupported(case, tmp_path):
    data, message = progressive_refusal_cases()[case]
    if message is None:
        assert jpeg.parse_jpeg(data).smooth is not None
        check_against_pil(save(tmp_path / "x.jpg", data))
        return
    with pytest.raises(ValueError, match=message):
        read_jpeg(data, device="cpu")


@pytest.mark.parametrize("kind", ["grey", "4:2:0"])
def test_damaged_progressive_streams_raise(kind):
    data = encode(image((48, 64), 9, kind), kind, 90, progressive=True,
                  restart_marker_rows=1)
    scans = progressive_scans(data)
    cuts = [scans[0][0] + 6, scans[1][0] + 30, scans[-1][0] - 3,
            (scans[2][0] + scans[2][1]) // 2, len(data) // 2,
            len(data) - 40, scans[-1][0]]
    for cut in cuts:
        for tail in (b"", b"\xff\xd9"):
            if cut == scans[-1][0] and tail:
                # the last scan dropped: a well-formed stream whose last
                # refinement is missing, which libjpeg block-smooths
                np.testing.assert_array_equal(
                    read_jpeg(data[:cut] + tail, 3, device="cpu"),
                    np.asarray(Image.open(io.BytesIO(
                        data[:cut] + tail)).convert("RGB")))
                continue
            with pytest.raises(ValueError, match="JPEG"):
                read_jpeg(data[:cut] + tail, device="cpu")
    for start, end in scans[::3]:
        bad = bytearray(data)
        bad[start + 20:start + 40] = b"\xff" * 20   # a run of 0xFF bytes
        with pytest.raises(ValueError, match="JPEG"):
            read_jpeg(bytes(bad), device="cpu")
