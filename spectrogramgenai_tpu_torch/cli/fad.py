"""FAD CLI (``spectrogramgenai_tpu/cli/fad.py``): the same flags and printed lines, plus ``--device``.

  python -m spectrogramgenai_tpu_torch.cli.fad --background_dir bg_audio \\
      --eval_dir eval_audio [--mode mel]
  python -m spectrogramgenai_tpu_torch.cli.fad --background_dir bg_audio --eval_dir eval_audio \\
      --mode clap --clap_ckpt models/clap_audio.msgpack
  python -m spectrogramgenai_tpu_torch.cli.fad --background_emb bg.npz --eval_emb ev.npz

Embeddings run on ``--device`` (CUDA by default; ``cpu`` for tests).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> float:
    from spectrogramgenai_tpu_torch.eval.fad import embeddings_for_dir, fad_score, load_embeddings

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--background_dir", default=None)
    p.add_argument("--eval_dir", default=None)
    p.add_argument("--background_emb", default=None, help="precomputed embeddings (CLAP etc.)")
    p.add_argument("--eval_emb", default=None)
    p.add_argument("--mode", default="mel", choices=["mel", "clap"])
    p.add_argument("--clap_ckpt", default=None,
                   help="converted CLAP audio tower (tools/convert_clap.py) for --mode clap")
    p.add_argument("--sample_rate", type=int, default=48000)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    a = p.parse_args(argv)

    if a.background_emb and a.eval_emb:
        bg, ev = load_embeddings(a.background_emb), load_embeddings(a.eval_emb)
        label = "precomputed embeddings"
    elif a.background_dir and a.eval_dir:
        if a.mode == "mel":
            print(
                "WARNING: --mode mel is a framework-native embedding, NOT the "
                "CLAP embedding the reference's FAD uses. Scores are only "
                "meaningful relative to other mel-mode scores; for "
                "reference-comparable FAD, provision CLAP weights "
                "(tools/provision_eval_weights.py) and pass --mode clap.",
                file=sys.stderr,
            )
        from spectrogramgenai_tpu_torch.cli.common import resolve_device

        device = resolve_device(a.device)
        bg = embeddings_for_dir(a.background_dir, a.mode, a.sample_rate, clap_ckpt=a.clap_ckpt, device=device)
        ev = embeddings_for_dir(a.eval_dir, a.mode, a.sample_rate, clap_ckpt=a.clap_ckpt, device=device)
        label = (f"{a.mode} embeddings" if a.mode == "clap"
                 else f"{a.mode} embeddings (relative comparisons only — not CLAP-comparable)")
    else:
        p.error("need either --background_dir/--eval_dir or --background_emb/--eval_emb")

    score = fad_score(bg, ev)
    print(f"FAD ({label}): {score:.6f}")
    return score


if __name__ == "__main__":
    main()
