"""The streaming blur kernel's launch geometry (`kernels/blur_stats.py::
launch_config`, the one owner of its grid and shared memory),
checked on the CPU at every stage of the paper's configuration, at every
odd k up to 15 and at the shapes the tests use: the blocks' (strip, band)
items cover every output pixel exactly once, the geometry does not depend
on the batch size, the shared memory fits a block and a lane's reads stay
inside the rows it stages."""
import inspect

import numpy as np
import pytest

from repro_torch.configs import cmax_camel
from repro_torch.kernels.blur_stats import STRIP, launch_config
from repro_torch.kernels.megakernel import SMEM_LIMIT

CAM = cmax_camel.CONFIG.camera
STAGE_SHAPES = [st.grid(CAM) for st in cmax_camel.CONFIG.stages]
SHAPES = sorted(set(STAGE_SHAPES) | {(48, 64), (45, 61), (45, 62), (20, 13),
                                     (20, 30), (32, 32), (1, 1), (3, 300)})
KS = list(range(1, 16, 2))


def _covered(cfg, H, W):
    """How many times the kernel's blocks (csrc/blur_stats.cu: block x of a
    window takes item x, band x // n_strips, strip x % n_strips) emit each
    output pixel."""
    seen = np.zeros((H, W), np.int64)
    for item in range(cfg.grid(1)[0]):
        band, strip = divmod(item, cfg.n_strips)
        r0, c0 = band * cfg.band_rows, strip * STRIP
        # rows past H are never walked, columns past W never folded
        seen[r0:min(r0 + cfg.band_rows, H), c0:min(c0 + STRIP, W)] += 1
    return seen


@pytest.mark.parametrize("hw", SHAPES)
def test_launch_config_covers_each_output_pixel_once(hw):
    H, W = hw
    for k in KS:
        cfg = launch_config(H, W, k)
        assert (_covered(cfg, H, W) == 1).all(), (hw, k)
        # every band holds at least one row, every strip one column
        assert (cfg.n_bands - 1) * cfg.band_rows < H
        assert (cfg.n_strips - 1) * STRIP < W


@pytest.mark.parametrize("hw", SHAPES)
def test_launch_config_fits_the_card(hw):
    H, W = hw
    for k in KS:
        cfg = launch_config(H, W, k)
        # a block stages its band's rows, halo included
        assert cfg.smem == (cfg.band_rows + k - 1) * 4 * cfg.seg * 4
        assert cfg.smem <= SMEM_LIMIT
        # the halo each side covers the taps, 16-byte copies stay aligned,
        # and the last lane's float2 reads (from the even column at or
        # before its first tap) stay inside the staged row segment
        assert cfg.pad >= k // 2 and cfg.pad % 4 == 0
        assert cfg.seg == STRIP + 2 * cfg.pad and cfg.seg % 4 == 0
        first = 2 * 31 + cfg.pad - k // 2
        skew = first % 2
        n_read = -(-(skew + k + 1) // 2) * 2
        assert first - skew >= 0 and first - skew + n_read <= cfg.seg
        # no band is shorter than max(4, (k - 1) // 2) rows unless the
        # grid is, which bounds the halo rows' extra horizontal FIR
        assert cfg.band_rows >= min(H, max(4, (k - 1) // 2))


@pytest.mark.parametrize("H,W,k", [(H, W, st.blur_taps) for (H, W), st in
                                   zip(STAGE_SHAPES,
                                       cmax_camel.CONFIG.stages)])
def test_launch_config_at_the_paper_stages(H, W, k):
    """The geometry does not depend on the batch size (it takes none), so a
    window's blocks and the order of its sums are the same at B = 1 and
    B = 8; each stage spreads a window over several blocks."""
    assert list(inspect.signature(launch_config).parameters) == \
        ["H", "W", "k"]
    cfg = launch_config(H, W, k)
    assert cfg == launch_config(H, W, k)
    assert cfg.grid(1)[0] == cfg.grid(8)[0] == cfg.items
    assert cfg.grid(8) == (cfg.items, 8)
    assert cfg.items >= 8
