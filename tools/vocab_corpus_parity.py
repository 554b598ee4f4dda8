"""The default ORB vocabulary corpus, the reference's against the port's,
on the CPU, at its full size (120 scenes; about two minutes each): not a
test (the tests hold one scene), a script that explains why the port's
trained ORB artifact is not the reference's bytes.

    JAX_PLATFORMS=cpu python tools/vocab_corpus_parity.py

Prints the rows that differ between the two corpora, each with its
keypoint in both packages (pixel, score, angle: a top-k order swap where
two scores lie an ulp apart, or a 32-bin angle edge), then the port's
vocabulary trained on its own corpus against the tracked artifact, key by
key, and its arrays' SHA-256 (``chip_smoke.py``'s ``[vocab]`` prints the
card's).
"""

import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from plslam_tpu.config import SlamConfig as JConfig  # noqa: E402
from plslam_tpu.frontend.stereo_points import (  # noqa: E402
    detect_and_describe as j_describe)
from plslam_tpu.loop import vocabulary as jV  # noqa: E402
from plslam_tpu_torch.config import SlamConfig  # noqa: E402
from plslam_tpu_torch.frontend.stereo_points import (  # noqa: E402
    detect_and_describe as t_describe)
from plslam_tpu_torch.loop import vocabulary as tV  # noqa: E402


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    K = 512
    ref = jV.build_default_corpus("orb")
    port = tV.build_default_corpus("orb", device="cpu", workers=4)
    print(f"corpora: reference {ref.shape}, sha256 {sha(ref)}; port "
          f"{port.shape}, sha256 {sha(port)}", flush=True)
    if ref.shape != port.shape:
        return 1
    rows = np.nonzero((ref != port).any(-1))[0]
    print(f"rows that differ: {len(rows)} of {len(ref)}", flush=True)
    scenes = tV.corpus_scenes("orb", tV.CORPUS_SCENES["orb"])
    jcfg = JConfig().with_updates(tV.CORPUS_UPDATES)
    tcfg = SlamConfig().with_updates(tV.CORPUS_UPDATES)
    j_fn = jax.jit(lambda im: j_describe(im, jcfg))
    for img_i in sorted(set(rows // K)):
        s, f = divmod(int(img_i), 2)
        im = tV.render_corpus_scene(scenes[s])[f]
        uj, _, _, aj, sj, _ = (np.asarray(x) for x in j_fn(jnp.asarray(im)))
        ut, _, _, at, st, _ = (x[0].numpy() for x in t_describe(
            torch.from_numpy(im)[None], tcfg))
        for r in rows[rows // K == img_i]:
            k = int(r % K)
            print(f"  row {r} (scene {s}, frame {f}, keypoint {k}): "
                  f"reference {uj[k]} score {sj[k]:.9g} angle {aj[k]:.8f}; "
                  f"port {ut[k]} score {st[k]:.9g} angle {at[k]:.8f}",
                  flush=True)
    voc = tV.build_vocabulary(port, k=10, levels=4, seed=1, device="cpu")
    z = np.load(tV.default_path("orb"))
    levels = tV.level_bits(voc)
    for key, mine in [(f"level_{i}", c) for i, c in enumerate(levels)] + [
            ("idf", voc.idf.numpy())]:
        d = np.nonzero(np.any((mine != z[key]).reshape(len(mine), -1),
                              -1))[0]
        print(f"port-trained {key} against the tracked artifact: "
              + (f"{len(d)} rows differ, the first {d[0]}" if len(d)
                 else "equal"), flush=True)
    arrays = {"idf": voc.idf.numpy(), "k": np.asarray(10),
              "levels": np.asarray(4),
              **{f"level_{i}": c for i, c in enumerate(levels)}}
    print("port-trained artifact's arrays' sha256 "
          f"{sha(*(arrays[k] for k in sorted(arrays)))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
