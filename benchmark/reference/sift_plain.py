"""A plain SIFT of one frame: the yardstick that decides ``correct``.

Plain PyTorch, one frame at a time, with no capacity: every extremum is
refined, every keypoint oriented and described.  It follows the C++
reference (github.com/ahmedhassayoune/sift-project, src/sift.cpp) in the
float32 arithmetic that ``sift_tpu_torch`` uses on the card, frozen here
so that a change to the program cannot move it: the same expression order
for every product and sum, true IEEE division where the reference divides,
the separable gaussian weights of the float32 profile, and the radius
classes and fixed lane chunks of the orientation and descriptor
contractions (cuBLAS picks its kernel, and with it the order of a sum, by
the batch size).  So on a frame whose counts fit the program's capacities
the program's keypoints and descriptor bytes are these, bit for bit.

It imports neither JAX nor the program.  ``describe(img, params)`` takes a
(H, W, 3) uint8 tensor on any device and returns the frame's keypoints
sorted and deduplicated as the reference's ``clean_keypoints`` leaves
them.  ``variant`` computes it otherwise, in the program's place when the
limits are set (``benchmark/control.py``):

* ``"reordered"``: a sound float32 program: every blur sums its taps from
  the outermost in and the contractions run in chunks of half the lanes;
* ``"tf32"``: the control, the nearest precision below float32: the
  blurs' and contractions' inputs rounded to TF32 (a 10-bit mantissa,
  round to nearest) before each product, the sums in float32, as a tensor
  core computes them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

M_PI2 = 6.283185307179586
MAX_CONVERGENCE_STEPS = 5
ORI_SMOOTH_ITERATIONS = 2
DESC_HIST_WIDTH = 4
DESC_HIST_BINS = 8
DESC_MAGNITUDE_THR = 0.2
INT_DESCR_FCTR = 512.0
# Lanes of one orientation / descriptor contraction at the largest window
# (the program's ``orient_all`` and ``compute_descriptors_all``).
ORI_CHUNK = {"cuda": 2048, "cpu": 256}
DESC_CHUNK = {"cuda": 512, "cpu": 64}
VARIANTS = ("frozen", "reordered", "tf32")

DEFAULTS = dict(
    double_image_size=True, init_sigma=1.6, intervals=3, window_size=3,
    contrast_threshold=0.04, eigen_ratio=10.0, num_bins=36, peak_ratio=0.8,
    ori_sigma_factor=1.5, desc_scale_factor=3.0, ratio_threshold=0.75, ori_cand_slots=8,
)


# --- the reference's host-side numbers (src/sift.cpp, src/image.cpp) -------

def gaussian_kernels(p) -> list[float]:
    n = p["intervals"] + 3
    ks = [0.0] * n
    ks[0] = p["init_sigma"]
    k = math.pow(2.0, 1.0 / p["intervals"])
    for i in range(1, n):
        ks[i] = math.pow(k, i - 1) * p["init_sigma"] * math.sqrt(k * k - 1)
    return ks


def half_kernel(sigma: float) -> list[float]:
    size = int(math.ceil(3 * sigma)) + 1
    exp_denom = 2 * sigma * sigma
    coef = 1 / (math.sqrt(2 * math.pi) * sigma)
    return [math.exp(-(i * i) / exp_denom) * coef for i in range(size)]


def weight_sum(kernel: list[float]) -> float:
    s = kernel[0]
    for u in range(1, len(kernel)):
        s += 2.0 * kernel[u]
    return s


def extremum_threshold(p) -> float:
    return math.floor(0.5 * p["contrast_threshold"] / float(p["intervals"]) * 255.0)


def max_size_octave(p) -> float:
    return p["init_sigma"] * math.pow(2, (p["intervals"] + 0.5) / p["intervals"])


def ori_radii(p) -> list[int]:
    r_max = int(math.ceil(3.0 * p["ori_sigma_factor"] * max_size_octave(p) + 0.5))
    return [r for r in (11, 13) if r < r_max] + [r_max]


def desc_radii(p) -> list[int]:
    hw = p["desc_scale_factor"] * max_size_octave(p)
    r_max = int(math.ceil(hw * 0.5 * math.sqrt(2.0) * (DESC_HIST_WIDTH + 1.0) + 1.0))
    return [r for r in (20, 24, 28, 32, 36) if r < r_max] + [r_max]


# --- elementwise helpers ---------------------------------------------------

def div(a: torch.Tensor, b) -> torch.Tensor:
    """True division (a tensor divided by a Python number on the card is a
    multiplication by its reciprocal)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest, ties away from
    zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0**30, neginf=-(2.0**30))
    return x.clamp(-(2.0**30), 2.0**30).to(torch.int32)


# --- stage 1: the pyramid ---------------------------------------------------

def blur(img: torch.Tensor, hk: list[float], variant: str = "frozen") -> torch.Tensor:
    """Separable blur, clamped borders, horizontal pass first, each pass
    img*k0 + k_u*(img[+u] + img[-u]) ... then / sum_w (src/image.cpp)."""
    sum_w = weight_sum(hk)
    for dim in (-1, -2):
        n = img.shape[dim]
        base = torch.arange(n, device=img.device)

        def tap(u):
            hi = img.index_select(dim, (base + u).clamp_max(n - 1))
            lo = img.index_select(dim, (base - u).clamp_min(0))
            return hi, lo

        if variant == "tf32":
            img = tf32(img)
            k = tf32(torch.tensor(hk, dtype=img.dtype, device=img.device))
            acc = img * k[0]
            for u in range(1, len(hk)):
                hi, lo = tap(u)
                acc = acc + k[u] * hi + k[u] * lo
        elif variant == "reordered":
            acc = None
            for u in range(len(hk) - 1, 0, -1):
                hi, lo = tap(u)
                acc = hk[u] * (hi + lo) if acc is None else acc + hk[u] * (hi + lo)
            acc = acc + img * hk[0]
        else:
            acc = img * hk[0]
            for u in range(1, len(hk)):
                hi, lo = tap(u)
                acc = acc + hk[u] * (hi + lo)
        img = div(acc, sum_w)
    return img


def upsample_x2(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x (src/image.cpp:62-88), lerps in the reference's order."""
    h, w = img.shape
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=-1)
    down = torch.cat([img[1:, :], img[-1:, :]], dim=-2)
    diag = torch.cat([down[:, 1:], down[:, -1:]], dim=-1)
    rows = []
    for dy in (0.0, 0.5):
        row = []
        for dx in (0.0, 0.5):
            v0 = img * (1.0 - dx) + right * dx
            v1 = down * (1.0 - dx) + diag * dx
            row.append(v0 * (1.0 - dy) + v1 * dy)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-3).reshape(2 * h, 2 * w)


def pyramid(img_u8: torch.Tensor, p):
    """(H, W, 3) uint8 -> per octave (gauss (S, H_o, W_o), DoG (S-1, ...))."""
    img = img_u8.to(torch.float32)
    gray = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]) + 0.0722 * img[..., 2]
    if p["double_image_size"]:
        gray = upsample_x2(gray)
    cur = blur(gray, half_kernel(math.sqrt(p["init_sigma"] * p["init_sigma"] - 1)), p["variant"])
    octaves = int(math.floor(math.log2(min(cur.shape) // 3)))
    hks = [half_kernel(s) for s in gaussian_kernels(p)[1:]]
    out = []
    for _ in range(octaves):
        layers = [cur]
        for hk in hks:
            layers.append(blur(layers[-1], hk, p["variant"]))
        g = torch.stack(layers)
        out.append((g, g[1:] - g[:-1]))
        cur = g[len(layers) - 3][::2, ::2][: g.shape[1] // 2, : g.shape[2] // 2].contiguous()
    return out


# --- stage 2: extrema and Newton refinement --------------------------------

def extrema(dog: torch.Tensor, thr: float, win: int) -> torch.Tensor:
    """(z, y, x) of every 26-neighbour extremum of one DoG stack, ascending."""
    b = win // 2
    wmax, wmin = dog, dog
    for dim in (-1, -2, -3):
        n = dog.shape[dim] - 2 * b
        wmax = torch.stack([wmax.narrow(dim, u, n) for u in range(win)]).amax(0)
        wmin = torch.stack([wmin.narrow(dim, u, n) for u in range(win)]).amin(0)
    c = dog[b:-b, b:-b, b:-b]
    mask = (c.abs() > thr) & ((c >= wmax) | (c <= wmin))
    return mask.nonzero() + b


def cubes(dog: torch.Tensor, zyx: torch.Tensor) -> torch.Tensor:
    d, h, w = dog.shape
    z = zyx[:, 0].long().clamp(1, d - 2)
    y = zyx[:, 1].long().clamp(1, h - 2)
    x = zyx[:, 2].long().clamp(1, w - 2)
    o = torch.arange(-1, 2, device=dog.device)
    e = (slice(None), None, None, None)
    return dog[z[e] + o[:, None, None], y[e] + o[None, :, None], x[e] + o[None, None, :]]


def refine(dog: torch.Tensor, zyx: torch.Tensor, octave: int, p):
    """src/sift.cpp:330-436: up to five Newton steps per extremum, then the
    contrast and edge tests.  Returns (x, y, layer, size) of the accepted
    ones, in the doubled image's coordinates."""
    depth, h, w = dog.shape
    border = p["window_size"] // 2
    pos = zyx.to(torch.int32)
    n = len(pos)
    zero = torch.zeros(n, dtype=dog.dtype, device=dog.device)
    active = torch.ones(n, dtype=torch.bool, device=dog.device)
    conv = torch.zeros_like(active)
    g, hs, off, center = (zero,) * 3, (zero,) * 6, (zero,) * 3, zero
    hi = torch.tensor([depth - 1 - border, h - 1 - border, w - 1 - border],
                      dtype=torch.int32, device=dog.device)
    for _ in range(MAX_CONVERGENCE_STEPS):
        c = div(cubes(dog, pos), 255.0)
        ng = (0.5 * (c[:, 2, 1, 1] - c[:, 0, 1, 1]), 0.5 * (c[:, 1, 1, 2] - c[:, 1, 1, 0]),
              0.5 * (c[:, 1, 2, 1] - c[:, 1, 0, 1]))
        ctr = c[:, 1, 1, 1]
        nh = (c[:, 0, 1, 1] - 2 * ctr + c[:, 2, 1, 1],
              c[:, 1, 1, 0] - 2 * ctr + c[:, 1, 1, 2],
              c[:, 1, 0, 1] - 2 * ctr + c[:, 1, 2, 1],
              0.25 * (c[:, 2, 1, 2] - c[:, 2, 1, 0] - c[:, 0, 1, 2] + c[:, 0, 1, 0]),
              0.25 * (c[:, 2, 2, 1] - c[:, 2, 0, 1] - c[:, 0, 2, 1] + c[:, 0, 0, 1]),
              0.25 * (c[:, 1, 0, 0] - c[:, 1, 0, 2] - c[:, 1, 2, 0] + c[:, 1, 2, 2]))
        g0, g1, g2 = ng
        h00, h11, h22, h01, h02, h12 = nh
        det = (h00 * h11 * h22 + 2 * (h01 * h12 * h02) - h02 * h11 * h02
               - h00 * h12 * h12 - h01 * h01 * h22)
        i00 = (h11 * h22 - h12 * h12) / det
        i01 = (h02 * h12 - h01 * h22) / det
        i02 = (h01 * h12 - h02 * h11) / det
        i11 = (h00 * h22 - h02 * h02) / det
        i12 = (h02 * h01 - h00 * h12) / det
        i22 = (h00 * h11 - h01 * h01) / det
        no = (-i00 * g0 - i01 * g1 - i02 * g2, -i01 * g0 - i11 * g1 - i12 * g2,
              -i02 * g0 - i12 * g1 - i22 * g2)
        max_off = torch.maximum(no[0].abs(), torch.maximum(no[1].abs(), no[2].abs()))
        now = active & (max_off < 0.5)
        moving = active & ~now
        step = torch.stack([to_i32(round_half_away(no[0])), to_i32(round_half_away(no[2])),
                            to_i32(round_half_away(no[1]))], dim=-1)
        new = pos + step
        inside = ((new[:, 2] >= border) & (new[:, 2] < w - border)
                  & (new[:, 1] >= border) & (new[:, 1] < h - border)
                  & (new[:, 0] >= border) & (new[:, 0] < depth - border))
        pos = torch.minimum(torch.where(moving[:, None], new, pos).clamp_min(border), hi)
        g = tuple(torch.where(now, a, b) for a, b in zip(ng, g))
        hs = tuple(torch.where(now, a, b) for a, b in zip(nh, hs))
        off = tuple(torch.where(now, a, b) for a, b in zip(no, off))
        center = torch.where(now, ctr, center)
        active, conv = moving & inside, conv | now

    g0, g1, g2 = g
    o0, o1, o2 = off
    _, h11, h22, _, _, h12 = hs
    interp = center + 0.5 * (g0 * o0 + g1 * o1 + g2 * o2)
    contrast = (interp.abs() * p["intervals"]) >= p["contrast_threshold"]
    tr = h11 + h22
    det2 = h11 * h22 - h12 * h12
    er = p["eigen_ratio"]
    keep = conv & contrast & (tr > 0) & ((tr * tr * er) < ((er + 1) * (er + 1) * det2))
    scale = torch.tensor(math.pow(2, octave), dtype=dog.dtype, device=dog.device)
    z, y, x = pos[:, 0], pos[:, 1], pos[:, 2]
    fx = scale * (x.to(dog.dtype) + o1)
    fy = scale * (y.to(dog.dtype) + o2)
    size = (p["init_sigma"] * scale) * torch.exp2(div(z.to(dog.dtype) + o0, float(p["intervals"])))
    return fx[keep], fy[keep], z[keep], size[keep]


# --- the radius classes -----------------------------------------------------

def by_class(radius: torch.Tensor, radii: list[int], chunk: int, args, fn) -> torch.Tensor:
    """``fn(args of a chunk of lanes, r)`` with each lane in the smallest
    window of ``radii`` covering its radius, in chunks of a fixed lane count
    (the last padded with its last lane), results in lane order."""
    t = torch.tensor(radii, dtype=radius.dtype, device=radius.device)
    cls = torch.searchsorted(t, radius).clamp_max(len(radii) - 1)
    side = 2 * radii[-1] + 1
    out = None
    for k, r in enumerate(radii):
        sel = (cls == k).nonzero()[:, 0]
        c = len(sel)
        if not c:
            continue
        lanes = chunk * max(1, side * side // (2 * r + 1) ** 2)
        pad = torch.arange(-(-c // lanes) * lanes, device=radius.device).clamp_max(c - 1)
        sub = [a[sel[pad]] for a in args]
        res = torch.cat([fn([a[s:s + lanes] for a in sub], r)
                         for s in range(0, len(pad), lanes)])[:c]
        if out is None:
            out = res.new_zeros((len(radius),) + res.shape[1:])
        out[sel] = res
    return out


def patches(gauss: torch.Tensor, layer, yc, xc, size: int) -> torch.Tensor:
    _, h, w = gauss.shape
    a = torch.arange(size, device=gauss.device)
    ys = (yc[:, None] + a).clamp(0, h - 1)
    xs = (xc[:, None] + a).clamp(0, w - 1)
    return gauss[layer[:, None, None], ys[:, :, None], xs[:, None, :]]


# --- stage 3: orientation ---------------------------------------------------

def chunk(table: dict, dev: torch.device, p) -> int:
    """Lanes of a contraction: the reordered program takes half."""
    return table[dev.type] // (2 if p["variant"] == "reordered" else 1)


def contract(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    if p["variant"] == "tf32":
        a, b = tf32(a), tf32(b)
    return torch.bmm(a, b)


def _histograms(gauss, args, r: int, nb: int, p) -> torch.Tensor:
    layer, xc, yc, x, y, radius, edenom = args
    _, hl, wl = gauss.shape
    dtype = edenom.dtype
    ii = torch.arange(-r, r + 1, device=gauss.device)
    ig, jg = ii[None, :], ii[:, None]
    pt = patches(gauss, layer, yc - r - 1, xc - r - 1, 2 * r + 3)
    dx = pt[:, 1:-1, 2:] - pt[:, 1:-1, :-2]
    dy = pt[:, :-2, 1:-1] - pt[:, 2:, 1:-1]
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)
    g1 = torch.exp(-(ii * ii).to(dtype)[None, :] / edenom[:, None])
    w_exp = g1[:, :, None] * g1[:, None, :]
    e = (slice(None), None, None)
    ok = ((ig.abs() <= radius[e]) & (jg.abs() <= radius[e])
          & (x[e] + ig - 1 >= 0) & (x[e] + ig + 1 <= wl - 1)
          & (y[e] + jg - 1 >= 0) & (y[e] + jg + 1 <= hl - 1))
    hb = round_half_away(div(nb * (ang + math.pi), M_PI2)).to(torch.int64)
    hb = torch.where(hb < nb, hb, torch.zeros_like(hb))
    contrib = torch.where(ok, w_exp * mag, torch.zeros_like(mag))
    onehot = F.one_hot(hb.reshape(len(x), -1), nb).to(dtype)
    return contract(contrib.reshape(len(x), 1, -1), onehot, p)[:, 0]


def orient(gauss: torch.Tensor, kx, ky, klayer, ksize, octave: int, p):
    """src/sift.cpp:447-533 for one octave's keypoints: (lane, ori) of every
    candidate in (keypoint, bin) order."""
    if not len(kx):
        return kx.new_zeros(0, dtype=torch.int64), kx.new_zeros(0)
    dtype = kx.dtype
    nb = p["num_bins"]
    _, hl, wl = gauss.shape
    pow_denom = torch.tensor(1.0 / math.pow(2, octave), dtype=dtype, device=kx.device)
    x = round_half_away(kx * pow_denom).to(torch.int64)
    y = round_half_away(ky * pow_denom).to(torch.int64)
    scale = p["ori_sigma_factor"] * (ksize * pow_denom)
    radius = round_half_away(3.0 * scale).to(torch.int64)
    edenom = 2.0 * scale * scale
    layer = klayer.long().clamp(0, gauss.shape[0] - 1)
    args = (layer, x.clamp(0, wl - 1), y.clamp(0, hl - 1), x, y, radius, edenom)
    hist = by_class(radius, ori_radii(p), chunk(ORI_CHUNK, kx.device, p), args,
                    lambda a, r: _histograms(gauss, a, r, nb, p))
    ht = list(hist.T.contiguous().unbind(0))
    for _ in range(ORI_SMOOTH_ITERATIONS):
        for i in range(nb):
            ht[i] = (0.25 * ht[(i - 1) % nb] + 0.5 * ht[i]) + 0.25 * ht[(i + 1) % nb]
    hist = torch.stack(ht, dim=1)
    top = hist.amax(dim=1, keepdim=True)
    h0, h2 = torch.roll(hist, 1, dims=1), torch.roll(hist, -1, dims=1)
    peak = (hist > h0) & (hist > h2) & (hist > p["peak_ratio"] * top)
    bins = torch.arange(nb, dtype=dtype, device=kx.device)[None, :]
    den = (h0 - 2 * hist) + h2
    den = torch.where(den == 0, torch.ones_like(den), den)
    at = torch.fmod(bins + 0.5 * (h0 - h2) / den + nb, float(nb))
    ori = torch.fmod(div(M_PI2 * at, float(nb)) + M_PI2, M_PI2)
    slots = p["ori_cand_slots"]
    if int(peak.sum(1).max()) > slots:
        raise ValueError(f"a keypoint has more than {slots} orientation peaks")
    lane, b = peak.nonzero(as_tuple=True)
    return lane, ori[lane, b]


# --- stage 5: descriptors ---------------------------------------------------

def _descriptors(gauss, args, r: int, p) -> torch.Tensor:
    layer, xc, yc, x, y, radius, hw, ca, sa, pori = args
    _, hl, wl = gauss.shape
    dtype = hw.dtype
    dev = hw.device
    nc = len(hw)
    offs = torch.arange(-r, r + 1, device=dev)
    rg, cg = offs[:, None].to(dtype), offs[None, :].to(dtype)
    e = (slice(None), None, None)
    pt = patches(gauss, layer, yc - r - 1, xc - r - 1, 2 * r + 3)
    dx = pt[:, 1:-1, 2:] - pt[:, 1:-1, :-2]
    dy = pt[:, :-2, 1:-1] - pt[:, 2:, 1:-1]
    inv = (1.0 / hw)[e]
    row_rot = (cg * sa[e] + rg * ca[e]) * inv
    col_rot = (cg * ca[e] - rg * sa[e]) * inv
    row_bin = (row_rot + DESC_HIST_WIDTH // 2) - 0.5
    col_bin = (col_rot + DESC_HIST_WIDTH // 2) - 0.5
    nx = x[e] + offs[None, None, :]
    ny = y[e] + offs[None, :, None]
    mask = ((row_bin > -1.0) & (row_bin < DESC_HIST_WIDTH)
            & (col_bin > -1.0) & (col_bin < DESC_HIST_WIDTH)
            & (nx > 0) & (nx < wl - 1) & (ny > 0) & (ny < hl - 1)
            & (offs.abs()[None, None, :] <= radius[e]) & (offs.abs()[None, :, None] <= radius[e]))
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx) - pori[e]
    ang = torch.fmod(torch.fmod(ang, M_PI2) + M_PI2, M_PI2)
    ori_bin = ang * (DESC_HIST_BINS / M_PI2)
    o2 = (offs * offs).to(dtype)
    coef = div((1.0 / hw) * (1.0 / hw), 0.5 * DESC_HIST_WIDTH * DESC_HIST_WIDTH)[:, None]
    g1 = torch.exp(-o2[None, :] * coef)
    m = torch.where(mask, mag * (g1[:, :, None] * g1[:, None, :]), torch.zeros_like(mag))
    row_bin, col_bin, ori_bin, m = (a.reshape(nc, -1) for a in (row_bin, col_bin, ori_bin, m))
    br, bc, bo = torch.floor(row_bin), torch.floor(col_bin), torch.floor(ori_bin)
    dr, dc, do = row_bin - br, col_bin - bc, ori_bin - bo
    br, bc, bo = (a.to(torch.int64)[..., None] for a in (br, bc, bo))
    rr = torch.arange(DESC_HIST_WIDTH, device=dev)
    oo = torch.arange(DESC_HIST_BINS, device=dev)
    fr = (m * (1.0 - dr))[..., None] * (br == rr) + (m * dr)[..., None] * ((br + 1) == rr)
    fc = (1.0 - dc)[..., None] * (bc == rr) + dc[..., None] * ((bc + 1) == rr)
    fo = ((1.0 - do)[..., None] * ((bo % DESC_HIST_BINS) == oo)
          + do[..., None] * (((bo + 1) % DESC_HIST_BINS) == oo))
    rc = fr[:, :, :, None] * fc[:, :, None, :]
    hist = contract(rc.reshape(nc, -1, 16).transpose(1, 2), fo, p).reshape(nc, 128)

    def inv_norm(a):
        norm = torch.sqrt((a * a).sum(dim=1, keepdim=True))
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        return torch.where(norm > 0, 1.0 / safe, torch.zeros_like(norm))

    hc = (hist * inv_norm(hist)).clamp_max(DESC_MAGNITUDE_THR)
    return torch.floor(INT_DESCR_FCTR * hc * inv_norm(hc)).to(torch.int32).clamp_max(255).to(torch.uint8)


def descriptors(gauss: torch.Tensor, kx, ky, ksize, kpori, klayer, octave: int, p):
    """src/sift.cpp:541-682 for one octave's final keypoints: (n, 128) uint8."""
    dtype = kx.dtype
    _, hl, wl = gauss.shape
    shift = 1 if p["double_image_size"] else 0
    pow_denom = torch.tensor(1.0 / math.pow(2, octave - shift), dtype=dtype, device=kx.device)
    x = (kx * pow_denom).to(torch.int64)
    y = (ky * pow_denom).to(torch.int64)
    hist_width = p["desc_scale_factor"] * (ksize * pow_denom)
    hw = torch.where(hist_width > 0, hist_width, torch.ones_like(hist_width))
    tmp = round_half_away(hist_width * 0.5 * math.sqrt(2.0) * (DESC_HIST_WIDTH + 1.0) + 0.5)
    diag = torch.tensor(math.sqrt(wl * wl + hl * hl), dtype=dtype, device=kx.device)
    radius = torch.minimum(tmp, diag).to(torch.int64)
    args = (klayer.long().clamp(0, gauss.shape[0] - 1), x.clamp(0, wl - 1), y.clamp(0, hl - 1),
            x, y, radius, hw, torch.cos(kpori), torch.sin(kpori), kpori)
    return by_class(radius, desc_radii(p), chunk(DESC_CHUNK, kx.device, p), args,
                    lambda a, r: _descriptors(gauss, a, r, p))


# --- the frame ---------------------------------------------------------------

def describe(img_u8: torch.Tensor, params: dict, variant: str = "frozen") -> dict:
    """Keypoints of one (H, W, 3) uint8 frame: a dict of tensors x, y, size,
    pori (float32), octave, layer (int32) and desc ((n, 128) uint8), sorted
    by (x, y, size desc, pori, octave desc) with duplicates removed, as the
    reference's clean_keypoints leaves them; and ``counts``: extrema and
    refined per frame, orientation candidates, the most peaks of any
    keypoint."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: {VARIANTS}")
    p = {**DEFAULTS, **{k: v for k, v in params.items() if k in DEFAULTS}, "variant": variant}
    pyr = pyramid(img_u8, p)
    thr = extremum_threshold(p)
    halve = 0.5 if p["double_image_size"] else 1.0
    cand, n_ext, n_ref = [], 0, 0
    for o, (g, d) in enumerate(pyr):
        zyx = extrema(d, thr, p["window_size"])
        n_ext += len(zyx)
        fx, fy, layer, size = refine(d, zyx, o, p)
        n_ref += len(fx)
        lane, ori = orient(g, fx, fy, layer, size, o, p)
        cand.append(dict(x=fx[lane] * halve, y=fy[lane] * halve, size=size[lane] * halve,
                         pori=ori, layer=layer[lane].to(torch.int32),
                         octave=torch.full_like(lane, o, dtype=torch.int32)))
    kp = {k: torch.cat([c[k] for c in cand]) for k in cand[0]}
    n_cand = len(kp["x"])
    # clean_keypoints: a stable lexicographic sort, then unique on (x, y, size, pori)
    order = torch.arange(n_cand, device=kp["x"].device)
    for key in (-kp["octave"], kp["pori"], -kp["size"], kp["y"], kp["x"]):
        order = order[torch.sort(key[order], stable=True).indices]
    kp = {k: v[order] for k, v in kp.items()}
    same = torch.ones(n_cand, dtype=torch.bool, device=order.device)
    for k in ("x", "y", "size", "pori"):
        same &= kp[k] == torch.roll(kp[k], 1)
    if n_cand:
        same[0] = False
    kp = {k: v[~same] for k, v in kp.items()}
    desc = torch.zeros((len(kp["x"]), 128), dtype=torch.uint8, device=order.device)
    for o, (g, _) in enumerate(pyr):
        sel = (kp["octave"] == o).nonzero()[:, 0]
        if len(sel):
            desc[sel] = descriptors(g, kp["x"][sel], kp["y"][sel], kp["size"][sel],
                                    kp["pori"][sel], kp["layer"][sel], o, p)
    kp["desc"] = desc
    kp["counts"] = dict(extrema=n_ext, refined=n_ref, oriented=n_cand)
    return kp
