"""The exact shortcuts of the augmentation kernels (csrc/augment.cu), written
as torch fp32 operations and held bit for bit against the operations they
replace, and the launch geometry of ``ops.augment``. CPU only, one thread.

- The uint8 table: x / 255 for each byte, and its brightness clip.
- The stats kernel's uint8 contrast mean: per channel the bytes below the
  clip's saturation threshold times fb / 255 plus the count of those at or
  above it; not exact, held to the 1e-6 of the kernel's check.
- The hue's remainders: mod 1 as x - trunc(x) signed as x, then moved to
  the divisor's sign; mod 6 as one subtraction of 6 on [0, 12).
"""

import numpy as np
import pytest
import torch

from eoe_tpu_torch.ops import augment as A
from eoe_tpu_torch.ops import preprocess as P
from tests.test_torch_kernels import AUG_CASES


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _table() -> torch.Tensor:
    """The kernels' table: each byte value divided by 255 in fp32."""
    return torch.arange(256, dtype=torch.float32) / torch.tensor(255.0)


def mod1(x: torch.Tensor) -> torch.Tensor:
    m = torch.copysign(x - torch.trunc(x), x)
    return torch.where(m < 0, m + 1.0, m)


def mod6(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 6.0, k - 6.0, k)


FACTORS = [0.0, 0.25, 0.6, 0.99, 1.0, 1.0 + 2 ** -23, 1.01, 1.2, 1.4, 1.99, 2.0, 3.7]


def test_byte_table_is_to_float():
    everything = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(_bits(_table()), _bits(P._to_float(everything)))
    expected = np.arange(256, dtype=np.float32) / np.float32(255)
    assert torch.equal(_bits(_table()), _bits(torch.from_numpy(expected)))


@pytest.mark.parametrize("fb", FACTORS)
def test_byte_table_clipped_is_the_brightness_clip(fb):
    """The table through the clip, and its threshold: every byte from the
    count of those below 1 on saturates, none before."""
    everything = torch.arange(256, dtype=torch.uint8)
    f = torch.tensor(fb, dtype=torch.float32)
    clipped = (_table() * f).clamp(0.0, 1.0)
    ref = (P._to_float(everything) * f).clamp(0.0, 1.0)
    assert torch.equal(_bits(clipped), _bits(ref))
    below = int((clipped < 1).sum())
    assert bool((clipped[below:] == 1).all()) and bool((clipped[:below] < 1).all())


def threshold_mean(images: torch.Tensor, fb) -> torch.Tensor:
    """The stats kernel's uint8 contrast mean, in integers and double: a
    factor above 1 clips the bytes from its threshold on."""
    n, h, w, c = images.shape
    weights = [1.0] if c == 1 else [float(np.float32(v)) for v in (0.299, 0.587, 0.114)]
    out = torch.empty(n, dtype=torch.float32)
    for b in range(n):
        f = 1.0 if fb is None else float(fb[b])
        below = int(((_table() * torch.tensor(f)).clamp(0.0, 1.0) < 1).sum()) if f > 1 else 256
        v = images[b].reshape(-1, c).long()
        sat = v >= below
        sums = torch.where(sat, 0, v).sum(0).tolist()
        counts = sat.sum(0).tolist()
        total = sum(wc * (f * s / 255.0 + k) for wc, s, k in zip(weights, sums, counts))
        out[b] = total / (h * w)
    return out


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("brightness", [False, True])
def test_threshold_mean_is_the_contrast_mean(c, brightness):
    g = torch.Generator().manual_seed(20)
    images = torch.randint(0, 256, (len(FACTORS), 24, 20, c), generator=g, dtype=torch.uint8)
    images[0] = 255
    images[1, :, :10] = 250
    fb = torch.tensor(FACTORS, dtype=torch.float32).reshape(-1, 1, 1, 1) if brightness else None
    ref = P.contrast_mean(images, fb).reshape(-1)
    ours = threshold_mean(images, fb)
    assert (ours - ref).abs().max().item() <= 1e-6


def _neighbours(centres, ulps: int = 64) -> torch.Tensor:
    """Each centre and its ``ulps`` nearest floats on either side."""
    out = []
    for c in centres:
        x = torch.tensor([float(c)], dtype=torch.float32)
        up, down = [x], [x]
        for _ in range(ulps):
            up.append(torch.nextafter(up[-1], torch.tensor([np.inf], dtype=torch.float32)))
            down.append(torch.nextafter(down[-1], torch.tensor([-np.inf], dtype=torch.float32)))
        out += up + down[1:]
    return torch.cat(out)


def test_mod1_is_remainder_near_whole_numbers():
    """h / 6 lies in [-1/6, 5/6] and h + d in [-0.5, 1.5]: every whole number
    from -2 to 3, and the ends of those ranges, with their neighbours."""
    x = _neighbours([-2, -1, 0, 1, 2, 3, -1 / 6, 5 / 6, -0.5, 1.5, 0.5])
    x = torch.cat([x, -x])
    assert torch.equal(_bits(mod1(x)), _bits(torch.remainder(x, 1.0)))


@pytest.mark.parametrize("lo,hi", [(-1 / 6, 5 / 6), (-0.5, 1.5), (-100.0, 100.0)])
def test_mod1_is_remainder_on_a_million_values(lo, hi):
    g = torch.Generator().manual_seed(21)
    x = torch.rand(1_000_000, generator=g) * (hi - lo) + lo
    assert torch.equal(_bits(mod1(x)), _bits(torch.remainder(x, 1.0)))


def test_mod6_is_remainder_where_the_chain_feeds_it():
    """n + 6h for n in {1, 3, 5} and h in [0, 1] lies in [1, 11]: the
    multiples of 6 in [0, 12) and the range's ends with their neighbours,
    and the chain's own values over a dense h."""
    k = _neighbours([0, 6, 1, 11, 5, 7, 3, 9], ulps=256)
    k = k[(k >= 0) & (k < 12)]
    assert torch.equal(_bits(mod6(k)), _bits(torch.remainder(k, 6.0)))
    h = torch.cat([torch.linspace(0, 1, 1_000_001), _neighbours([0, 0.5, 1])])
    h = h[(h >= 0) & (h <= 1)]
    for n in (1.0, 3.0, 5.0):
        k = n + h * 6.0
        assert torch.equal(_bits(mod6(k)), _bits(torch.remainder(k, 6.0)))


def _hue_shift_as_the_kernel(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """csrc/augment.cu's shift_hue in torch ops, with its remainders."""
    r, g, b = x.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    deltac = maxc - minc
    s = torch.where(maxc > 0, deltac / maxc.clamp(min=1e-12), torch.zeros_like(maxc))
    dc = deltac.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / dc, (maxc - g) / dc, (maxc - b) / dc
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac > 0, mod1(h / 6.0), torch.zeros_like(h))
    h = mod1(h + d)

    def channel(n):
        k = mod6(n + h * 6.0)
        return maxc - maxc * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1)


@pytest.mark.parametrize("hue", [0.01, 0.2, 0.5])
def test_hue_chain_with_the_shortcuts_is_color_jitters(hue):
    """Every colour of a coarse RGB lattice, grey included, and random ones,
    shifted by drawn hues: the kernel's chain gives color_jitter's bits."""
    g = torch.Generator().manual_seed(22)
    levels = torch.arange(0, 256, 15, dtype=torch.uint8)
    lattice = torch.cartesian_prod(levels, levels, levels)
    images = torch.cat([lattice, torch.randint(0, 256, (20_000, 3), generator=g,
                                               dtype=torch.uint8)])
    images = P._to_float(images.reshape(-1, 1, 1, 3))
    d = P._uniform(len(images), (1, 1), -hue, hue, images, g)
    ref = P.color_jitter(images, hue=d)
    ours = _hue_shift_as_the_kernel(images, d)
    assert torch.equal(_bits(ours), _bits(ref))


STACKS = [(128, 224, 224, 3), (128, 32, 32, 3)]   # acceptance and WRN, CIFAR-10


def _geometry_cases():
    cases = [(n, size, size, c) for n, _h, _w, c, size, *_ in AUG_CASES]
    return cases + STACKS + [(65537, 3, 3, 3), (65537, 224, 224, 3), (1, 1, 1, 1),
                             (2, 5000, 1100, 3)]


@pytest.mark.parametrize("n,th,tw,c", _geometry_cases())
@pytest.mark.parametrize("elem", [1, 4])
def test_apply_geometry_covers_every_row_once(n, th, tw, c, elem):
    geo = A.apply_geometry(n, th, tw, c, elem)
    quads = -(-tw // 4)
    assert geo.rows >= 1 and (geo.rows == 1 or geo.rows * quads <= A.APPLY_THREADS)
    # a block's worth of quads, halved only while the grid is small
    full_rows = max(1, min(th, A.APPLY_THREADS // quads))
    assert geo.rows == full_rows or n * -(-th // (2 * geo.rows)) < A.MIN_BLOCKS
    band = geo.rows * geo.steps
    assert band * geo.bands >= th and band * (geo.bands - 1) < th   # no band empty
    assert 1 <= geo.bands <= 65535
    # enough blocks to fill the card, unless an image has no more stages
    assert n * geo.bands >= A.FILL_BLOCKS or geo.steps == 1
    # a staged row holds the window and its 16-byte hull
    assert geo.pitch % 16 == 0 and geo.pitch >= -(-(15 + tw * c * elem) // 16) * 16
    assert geo.smem == (1024 if elem == 1 else 0) + 2 * geo.rows * geo.pitch <= A.MAX_SMEM


def test_apply_geometry_of_the_stacks():
    """The acceptance and WRN crops: 4 rows of 56 quads a stage, 8 bands of 7
    stages; CIFAR-10: 16 rows a stage, 2 bands of one stage (256 blocks)."""
    for (n, size, elem), expected in {(128, 224, 1): (4, 7, 8), (128, 32, 1): (16, 1, 2),
                                      (65537, 3, 4): (3, 1, 1)}.items():
        geo = A.apply_geometry(n, size, size, 3, elem)
        assert (geo.rows, geo.steps, geo.bands) == expected


@pytest.mark.parametrize("h,th,contrast,cluster", [
    (256, 224, True, 8), (256, 224, False, 7), (32, 32, False, 1), (40, 32, True, 2),
    (130, 64, True, 5), (100, 90, False, 3), (4, 3, False, 1), (16, 22, False, 1),
    (4096, 4096, True, 8)])
def test_stats_geometry(h, th, contrast, cluster):
    """Blocks per image by the rows read: a band of STATS_ROWS rows or more
    each, at most MAX_CLUSTER."""
    assert A.stats_geometry(h, th, contrast) == cluster
