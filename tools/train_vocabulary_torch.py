"""Offline vocabulary training on the port (DBoW2 TemplatedVocabulary::
create parity: vocabularies are trained offline on an image corpus and
shipped as artifacts).

Trains the ORB and LBD vocabularies on the randomized textured synthetic
corpus (``plslam_tpu_torch.loop.vocabulary.build_default_corpus``: the
scenes rendered on the host, described by the port's front end on the
device; the k-majority on the host; the IDF statistics through kernel L)
and writes ``vocab_default_{kind}_{k}_{levels}_v2.npz`` into ``--out``
(default: the package's ``data/``, where ``default_vocabulary`` reads
them). Runs on the CUDA device; ``--device cpu`` runs the plain versions.

    python tools/train_vocabulary_torch.py [--device cuda] [--out DIR]
        [--k 10] [--levels 4] [--kind orb|lbd|both] [--scenes N]
        [--workers W]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from plslam_tpu_torch import resolve_device  # noqa: E402
from plslam_tpu_torch.loop import vocabulary as V  # noqa: E402


def train(kind: str, k: int, levels: int, device, out: str,
          n_scenes=None, workers: int = 0) -> str:
    """Train one family and write its artifact; prints the reference
    tool's lines (corpus size, empty-leaf share, idf range and median).
    Returns the artifact's path."""
    t0 = time.time()
    desc = V.build_default_corpus(kind, n_scenes, device=device,
                                  workers=workers)
    print(f"{kind}: corpus {desc.shape[0]} descriptors "
          f"({time.time() - t0:.0f}s)", flush=True)
    voc = V.build_vocabulary(desc, k=k, levels=levels, seed=1, device=device)
    leaves = V.transform_leaves(voc, torch.from_numpy(desc).to(
        voc.flat.device)).cpu().numpy()
    occ = np.bincount(leaves, minlength=voc.n_leaves)
    empty = float(np.mean(occ == 0))
    idf = voc.idf.cpu().numpy()
    print(f"{kind}: empty leaves {empty * 100:.1f}%  "
          f"idf [{idf.min():.2f}, {idf.max():.2f}] "
          f"median {np.median(idf):.2f} ({time.time() - t0:.0f}s)",
          flush=True)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, os.path.basename(V.default_path(kind, k,
                                                             levels)))
    V.save_vocabulary(voc, path)
    print(f"{kind}: wrote {path}", flush=True)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.dirname(V.default_path()))
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--kind", choices=("orb", "lbd", "both"),
                    default="both")
    ap.add_argument("--scenes", type=int, default=None,
                    help="scenes a family (default: 120 ORB, 400 LBD)")
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count()),
                    help="processes that render the scenes (0: this one)")
    a = ap.parse_args(argv)
    for kind in (("orb", "lbd") if a.kind == "both" else (a.kind,)):
        train(kind, a.k, a.levels, resolve_device(a.device), a.out,
              a.scenes, a.workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
