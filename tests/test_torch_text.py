"""The port's text overlay without OpenCV: the TrueType reader
(``utils/truetype.py``) against fontTools, and ``utils/text.put_text_u8``
against OpenCV 5.0's ``cv2.putText``, value for value, on the cases that
``tests/text_cases.py`` pins; the realtime pipeline's overlay against the JAX
runner's.

Tolerance: none. Every canvas equals cv2's byte for byte.
"""

import hashlib
import sys
import types

import numpy as np
import pytest

import text_cases as C
from caffe_rtpose_tpu.pipeline import runner as JR
from caffe_rtpose_tpu_torch.pipeline import runner as PR
from caffe_rtpose_tpu_torch.pose import descriptor as D
from caffe_rtpose_tpu_torch.utils import text as T
from caffe_rtpose_tpu_torch.utils import truetype as TT

cv2 = pytest.importorskip("cv2")
WEIGHTS = (300, 400, 700)


@pytest.fixture(scope="module")
def font():
    return TT.load_font()


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_font_file_and_licence():
    """The committed font is the stream cv2 5.0.0 embeds, and its licence
    file names the font's copyright line and the SIL OFL 1.1."""
    with open(TT.RUBIK_PATH, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == TT.RUBIK_SHA256
    with open(f"{TT.FONTS_DIR}/OFL.txt") as f:
        lic = f.read()
    assert "Copyright 2015 The Rubik Project Authors" in lic
    assert "SIL OPEN FONT LICENSE Version 1.1" in lic and TT.RUBIK_SHA256 in lic


@pytest.fixture(scope="module")
def ft():
    ttlib = pytest.importorskip("fontTools.ttLib")
    return ttlib.TTFont(TT.RUBIK_PATH)


def _ft_points(glyph_set, name):
    """fontTools' outline points (composites decomposed) and on-curve flags."""
    from fontTools.pens.pointPen import AbstractPointPen
    from fontTools.pens.transformPen import TransformPointPen

    class Pen(AbstractPointPen):
        def __init__(self):
            self.pts, self.on = [], []

        def beginPath(self, **kw):
            pass

        def endPath(self):
            pass

        def addPoint(self, pt, segmentType=None, smooth=False, name=None, **kw):
            self.pts.append(pt)
            self.on.append(segmentType is not None)

        def addComponent(self, base, transform, **kw):
            glyph_set[base].drawPoints(TransformPointPen(self, transform))

    pen = Pen()
    glyph_set[name].drawPoints(pen)
    return np.asarray(pen.pts, np.float64).reshape(-1, 2), np.asarray(pen.on, bool)


def test_cmap_metrics_and_axes(font, ft):
    assert font.cmap == {c: ft.getGlyphID(n) for c, n in ft.getBestCmap().items()}
    assert (font.units_per_em, font.ascent, font.descent) == (
        ft["head"].unitsPerEm, ft["hhea"].ascent, ft["hhea"].descent)
    ax = ft["fvar"].axes[0]
    assert font.axes == (TT.Axis("wght", ax.minValue, ax.defaultValue, ax.maxValue),)
    assert [int(v) for v in font.advances] == [ft["hmtx"][n][0] for n in ft.getGlyphOrder()]


@pytest.mark.parametrize("weight", WEIGHTS)
def test_outlines_and_advances_equal_fonttools(font, ft, weight):
    """Every ASCII glyph and every tenth glyph of the font (composites among
    them) at the same normalized location: outline points and on-curve
    flags (gvar with IUP) and HVAR advances."""
    norm = font.normalize({"wght": weight})
    gs = ft.getGlyphSet(location={"wght": norm[0] / 16384}, normalized=True)
    order = ft.getGlyphOrder()
    gids = sorted({font.glyph_index(c) for c in range(32, 127)} | set(range(0, len(order), 10)))
    assert any(ft["glyf"][order[g]].isComposite() for g in gids)
    for g in gids:
        mine = font.glyph(g, norm)
        pts, on = _ft_points(gs, order[g])
        np.testing.assert_array_equal(mine.points, pts, err_msg=order[g])
        np.testing.assert_array_equal(mine.on_curve, on, err_msg=order[g])
        assert font.advance(g, norm) == pytest.approx(gs[order[g]].width, abs=1e-9), order[g]


@pytest.mark.parametrize("weight", WEIGHTS)
def test_opencv_instance_is_the_floored_outline(font, weight):
    """OpenCV's fixed-point instance (what the rasteriser draws) is the
    exact instance floored, within one font unit where the 16.16 scalars
    round, and the exact one itself at the default weight."""
    norm = font.normalize({"wght": weight})
    for c in range(33, 127):
        g = font.glyph_index(c)
        exact, cv = font.glyph(g, norm), font.glyph_opencv(g, norm)
        assert np.all(cv.points == np.floor(cv.points))
        assert np.abs(cv.points - np.floor(exact.points)).max() <= (1 if weight != 300 else 0)
        assert cv.ends == exact.ends and np.array_equal(cv.on_curve, exact.on_curve)


@pytest.mark.parametrize("group", sorted(C.DIGESTS))
def test_cv2_gives_the_pinned_digests(group):
    assert C.group_digest(lambda *a: cv2.putText(*a), group) == C.DIGESTS[group]


@pytest.mark.parametrize("group", sorted(C.DIGESTS))
def test_put_text_gives_the_pinned_digests(group, no_cv2):
    assert C.group_digest(T.put_text_u8, group) == C.DIGESTS[group]


@pytest.mark.parametrize("scale", (0.2, 0.33, 0.5, 0.75, 0.87, 1.0, 1.24, 1.5, 2.0))
@pytest.mark.parametrize("thickness", (1, 2, 4))
def test_scales_and_thicknesses_equal_cv2(scale, thickness, no_cv2):
    """cv2's pixel size (scale * 100 / 3.7, rounded: 0.87 and 1.24 round
    up past 27 * scale) and weight (400, or 600 above thickness 1), on a
    white, a black and a noise canvas, gray and BGR."""
    rs = np.random.RandomState(int(scale * 100) + thickness)
    text = "Ag8 %@ 12.3 fps"
    for bg in (np.zeros((120, 420, 3), np.uint8), np.full((120, 420), 255, np.uint8),
               rs.randint(0, 256, (120, 420, 3)).astype(np.uint8)):
        color = tuple(int(v) for v in rs.randint(0, 256, 3))
        want = bg.copy()
        cv2.putText(want, text, (3, 80), cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness)
        got = T.put_text_u8(bg.copy(), text, (3, 80), T.FONT_HERSHEY_SIMPLEX, scale, color,
                            thickness)
        np.testing.assert_array_equal(got, want)


def test_refusals():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="FONT_HERSHEY_SIMPLEX"):
        T.put_text_u8(img, "a", (0, 5), 1, 0.5, (255, 255, 255))
    with pytest.raises(ValueError, match="positive"):
        T.put_text_u8(img, "a", (0, 5), 0, -0.5, (255, 255, 255))
    with pytest.raises(ValueError, match="u8"):
        T.put_text_u8(img.astype(np.float32), "a", (0, 5), 0, 0.5, (255, 255, 255))


@pytest.mark.parametrize("model", ("COCO", "MPI"))
def test_overlay_equals_jax_runner(model, no_cv2):
    """The port's RtPosePipeline._overlay_text, cv2 blocked, against the JAX
    runner's on the same canvases, people counts and every part_to_show
    (0-55), with both runners' _emit_times fixed so that the fps and s/gpu
    labels are the same."""
    desc = D.COCO_18 if model == "COCO" else D.MPI_15
    rs = np.random.RandomState(len(desc.part_names))
    emit = [[], [5.0], [5.0, 5.04], [0.0, 0.5, 1.25],
            list(np.cumsum(rs.uniform(0.01, 0.1, 30)))]
    for p2s in range(56):
        for write_frames in ("", "frames"):
            times = emit[p2s % len(emit)]
            people = int(rs.randint(0, 120))
            canvas = rs.randint(0, 256, (120, 320, 3)).astype(np.uint8)
            outs = []
            for mod in (PR, JR):
                pipe = mod.RtPosePipeline.__new__(mod.RtPosePipeline)
                pipe.cfg = mod.PipelineConfig(write_frames=write_frames)
                pipe.ui = mod.UIState(part_to_show=p2s)
                pipe.est = types.SimpleNamespace(descriptor=desc)
                pipe._emit_times = list(times)
                frame = types.SimpleNamespace(num_people=people)
                outs.append(pipe._overlay_text(canvas.copy(), frame))
            np.testing.assert_array_equal(outs[0], outs[1], err_msg=f"part_to_show {p2s}")
