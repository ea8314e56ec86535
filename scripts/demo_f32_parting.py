"""Where the port's float32 run and the JAX package's part on the demo pair.

    JAX_PLATFORMS=cpu python scripts/demo_f32_parting.py

CPU only, about three minutes.  Runs the demo pair (tests/data/oracle_demo{1,2}.npz,
capacities 8192/2048/2048, float32) four ways and prints, per image, the keypoint
count and the oracle keypoints missing (and any extra), each as one JSON line:

* ``jax``: the JAX package's XLA route (``use_pallas_pyramid=False``);
* ``port``: the port's ``run_route(.., "stacks")``;
* ``jax_stages_on_port_pyramid``: JAX's stage programs fed the port's pyramid;
* ``port_stages_on_jax_pyramid``: the port's stages fed JAX's pyramid.

Then the grayscale image, the first float32 operation of the pyramid: how
many of JAX's pixels differ from the separately rounded products and sums
the port computes (the C++ reference's order), and from fused
multiply-adds.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sift_tpu import SiftConfig as JaxConfig  # noqa: E402
from sift_tpu.models import sift as JS  # noqa: E402
from sift_tpu.ops.color import to_grayscale as jax_gray  # noqa: E402
from sift_tpu_torch import SiftConfig  # noqa: E402
from sift_tpu_torch.models import sift as S  # noqa: E402
from sift_tpu_torch.ops.gather import StackSpace  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")
CAPS = dict(extrema_cap=8192, kp_cap=2048, ori_cap=2048)
OD = [np.load(os.path.join(DATA, f"oracle_demo{i}.npz")) for i in (1, 2)]
IMGS = np.stack([o["input"] for o in OD]).astype(np.float32)


def unmatched(a, b):
    """(x, y, size) rows of ``a`` with no row of ``b`` within 0.01 in each."""
    if not len(b):
        return a.round(3).tolist()
    return a[np.abs(a[:, None] - b[None]).max(-1).min(1) > 0.01].round(3).tolist()


def report(name, kp):
    out = {}
    for i, o in enumerate(OD):
        v = np.asarray(kp.valid[i])
        mine = np.stack([np.asarray(getattr(kp, f)[i])[v].astype(np.float64)
                         for f in ("x", "y", "size")], 1)
        want = np.stack([o[f"final.{f}"] for f in ("x", "y", "size")], 1)
        out[f"demo{i + 1}"] = dict(keypoints=int(v.sum()), missing=unmatched(want, mine),
                                   extra=unmatched(mine, want))
    print(json.dumps({name: out}), flush=True)


def main():
    cfg = SiftConfig(**CAPS)
    jcfg = JaxConfig(dtype=jnp.float32, use_pallas_pyramid=False, **CAPS)
    report("jax", JS.detect_and_describe_batch(jnp.asarray(IMGS), jcfg))
    imgs = S.as_batch(IMGS, cfg, "cpu")
    report("port", S.run_route(imgs, cfg, "stacks")[0])

    gaussians, dogs = S.pyramids(imgs, cfg)
    kp, _, _ = JS._jit_detect_refine_batch([jnp.asarray(d.numpy()) for d in dogs], jcfg)
    mr = JS._jit_gauss_rows_batch([jnp.asarray(g.numpy()) for g in gaussians])
    cand, _, _ = JS._jit_orient_batch(mr, kp, jcfg)
    report("jax_stages_on_port_pyramid", JS._jit_dedup_compact_batch(cand, jcfg.ori_cap))

    jg, jd = JS._jit_pyramids_batch(jnp.asarray(IMGS), jcfg, len(gaussians))
    gaussians = [torch.from_numpy(np.array(a)) for a in jg]
    kp, _ = S._detect_refine_fused([torch.from_numpy(np.array(a)) for a in jd], cfg, False)
    gsp = StackSpace.build(gaussians)
    cand, _ = S.orient(gsp, kp, cfg)
    report("port_stages_on_jax_pyramid", S.dedup(cand, cfg))

    r, g, b = (IMGS[..., c] for c in range(3))
    w = [np.float32(c) for c in (0.2126, 0.7152, 0.0722)]
    separate = (w[0] * r + w[1] * g) + w[2] * b
    f64 = np.float64
    fused = (f64(w[0]) * r + f64(w[1] * g)).astype(np.float32)
    fused = (f64(fused) + f64(w[2]) * b).astype(np.float32)
    jgray = np.asarray(jax.jit(jax_gray)(jnp.asarray(IMGS)))
    print(json.dumps({"grayscale": dict(
        pixels=int(jgray.size), jax_vs_separately_rounded=int((jgray != separate).sum()),
        jax_vs_fused_multiply_adds=int((jgray != fused).sum()))}), flush=True)


if __name__ == "__main__":
    main()
