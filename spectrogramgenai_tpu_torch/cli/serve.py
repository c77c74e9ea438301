"""Generation serving CLI: load a DDPM checkpoint, serve batched requests.

A dynamic-batching HTTP service around the sampler: concurrent
POST /generate requests coalesce into fixed-shape reverse-diffusion chains
(see serving/server.py).

  python -m spectrogramgenai_tpu_torch.cli.serve --run.run_name ddpm \\
      --vqae_ckpt models/vqvae --port 8000 --serve_batch 27 \\
      --train_folder_for_classes datasets/train

Default sampler is DPM-Solver++(2M) at 20 steps; pass --sampler ddim
--num_steps 50 (or ddpm for the 999-step chain) to override. Runs on CUDA
unless --device says otherwise. ``--artifact models/ddpm_sampler.zip``
serves an exported sampler (cli.export_model) instead: no checkpoint and no
model code; the artifact fixes the batch, sampler, steps and CFG scale. It
is a one-device program, so it is refused under ``torchrun`` with more than
one rank.

Under ``torchrun`` one process per card serves over the (``--run.mesh_data``,
``--run.mesh_model``) mesh (``--run.param_sharding``, tensor parallel by
default): each batch's labels split over the data axis, the wide layers
over the model axis. Rank 0 is the front (HTTP, the queue, PNGs, audio);
the other ranks follow it over the mesh's control channel, where they wait
through idle time. SIGINT to rank 0 stops every rank; each
prints its ``rank {...}`` line and exits 0. Mesh flags that ask for more
ranks than there are raise.

  torchrun --standalone --nproc_per_node 8 -m spectrogramgenai_tpu_torch.cli.serve \\
      --run.run_name ddpm --vqae_ckpt models/vqvae --port 8000 --serve_batch 32 [--run.mesh_model 2]

  curl -X POST localhost:8000/generate -d '{"label": "bird_a", "count": 2}'
  curl -X POST localhost:8000/generate -d '{"label": 0, "audio": true}'  # base64 WAVs too
  curl localhost:8000/stats
"""

from __future__ import annotations

import argparse
import os


def run(cfg, *, port: int, host: str = "127.0.0.1", serve_batch: int = 27,
        max_delay_ms: float = 50.0, sampler: str = "dpmpp", num_steps: int = 20,
        use_ema: bool = False, class_names: list[str] | None = None, warmup: bool = True,
        block: bool = True, device: str = "cuda", audio_out_sr: int | None = None, audio_gl_iters: int = 32,
        warm_audio: bool = False, artifact: str | None = None, mesh=None):
    """Start the server; returns (server, batcher) on rank 0. ``mesh`` is the
    run's (``cli.common.setup``), made here where not given. A follower rank
    runs the front's batches until it stops, prints its rank line and
    returns (None, None)."""
    from spectrogramgenai_tpu_torch.audio.invert import AudioReconstructor
    from spectrogramgenai_tpu_torch.cli.common import make_mesh, report_rank, resolve_device
    from spectrogramgenai_tpu_torch.serving import BatchingSampler, GenerationHTTPServer, RankGroup
    from spectrogramgenai_tpu_torch.serving.server import sample_fn

    if artifact:  # an exported sampler: no checkpoint, no model code
        from spectrogramgenai_tpu_torch.serving.export import load_artifact

        art = load_artifact(artifact, device=resolve_device(device))
        batcher = BatchingSampler.from_artifact(art, max_delay_ms=max_delay_ms, seed=cfg.run.seed)
        serve_batch, sampler = art.num_labels, art.manifest["sampler"]
    else:
        from spectrogramgenai_tpu_torch.cli.common import load_task

        dev = resolve_device(device)
        mesh = make_mesh(cfg.run, dev) if mesh is None else mesh
        task = load_task(cfg, dev, use_ema=use_ema, mesh=mesh)
        ranks = RankGroup(mesh) if mesh.world > 1 else None
        if not mesh.is_main:
            ranks.follow(sample_fn(task, seed=cfg.run.seed, sampler=sampler, num_steps=num_steps, cfg_scale=None))
            report_rank(mesh, batches=ranks.batches)
            return None, None
        if ranks is not None:
            print(f"serve: rank 0 of {mesh.world} is the front, ranks 1-{mesh.world - 1} follow "
                  f"(mesh {mesh.data}x{mesh.model}, {cfg.run.param_sharding}, {mesh.backend()})", flush=True)
        if serve_batch % mesh.data:
            print(f"serve: the serve batch {serve_batch} does not split over the data axis {mesh.data}: "
                  f"every rank runs all its labels", flush=True)
        batcher = BatchingSampler(task, batch_size=serve_batch, max_delay_ms=max_delay_ms,
                                  sampler=sampler, num_steps=num_steps, seed=cfg.run.seed, ranks=ranks)
    audio_rec = AudioReconstructor(gl_iters=audio_gl_iters, out_sr=audio_out_sr, device=batcher.device)
    if warmup:
        # one chain before accepting traffic: builds the kernels, warms the allocator
        print(f"serve: warming up ({sampler}, batch {serve_batch})…", flush=True)
        img = batcher.submit(0, 1).result()
        if warm_audio:
            print("serve: warming audio inversion…", flush=True)
            audio_rec.warmup(img.shape[1], img.shape[2], counts=(1,))
        print("serve: warmup done", flush=True)

    server = GenerationHTTPServer(batcher, class_names, host=host, port=port, audio=audio_rec)
    print(f"serve: listening on {host}:{server.port} "
          f"(batch {serve_batch}, window {max_delay_ms}ms, {sampler}, {batcher.device})", flush=True)
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            batcher.close()
        if mesh is not None:
            report_rank(mesh, batches=batcher.stats["batches"])
    else:
        server.start()  # background handler thread; caller owns shutdown()
    return server, batcher


def main(argv=None):
    from spectrogramgenai_tpu_torch.cli.common import resolve_device, setup
    from spectrogramgenai_tpu_torch.core.config import DDPMConfig, add_config_args, apply_overrides

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--serve_batch", type=int, default=27,
                   help="label batch per chain (27 → 54 rows through the UNet with CFG)")
    p.add_argument("--max_delay_ms", type=float, default=50.0,
                   help="dynamic-batching coalescing window")
    p.add_argument("--sampler", default="dpmpp", choices=["ddpm", "ddim", "dpmpp"],
                   help="dpmpp = DPM-Solver++(2M), the serving default; ddpm = 999-step chain")
    p.add_argument("--num_steps", type=int, default=None,
                   help="DDIM/DPM-Solver++ steps (default: 20 for dpmpp, 50 for ddim)")
    p.add_argument("--use_ema", type=int, default=0)
    p.add_argument("--artifact", default=None,
                   help="serve an exported sampler (cli.export_model) instead of a checkpoint; "
                        "overrides the batch and sampler flags; one rank only")
    p.add_argument("--train_folder_for_classes", default=None)
    p.add_argument("--audio_out_sr", type=int, default=None,
                   help='resample "audio": true responses (e.g. 48000 for CLAP)')
    p.add_argument("--audio_gl_iters", type=int, default=32,
                   help="Griffin-Lim iterations for audio reconstruction")
    p.add_argument("--warm_audio", action="store_true",
                   help="also run one audio inversion at startup")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    add_config_args(p, DDPMConfig)
    a = p.parse_args(argv)
    cfg = apply_overrides(DDPMConfig(), a)
    if a.artifact and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise ValueError(f"--artifact serves a one-device program; start it without torchrun, not on "
                         f"{os.environ['WORLD_SIZE']} ranks")
    mesh = setup(cfg.run, resolve_device(a.device))

    if a.train_folder_for_classes:
        from spectrogramgenai_tpu_torch.data.manifest import class_names_from_folder

        class_names = class_names_from_folder(a.train_folder_for_classes)
    else:
        class_names = [f"class{i:02d}" for i in range(cfg.num_classes)]

    num_steps = a.num_steps if a.num_steps else (20 if a.sampler == "dpmpp" else 50)
    run(cfg, port=a.port, host=a.host, serve_batch=a.serve_batch,
        max_delay_ms=a.max_delay_ms, sampler=a.sampler, num_steps=num_steps,
        use_ema=bool(a.use_ema), class_names=class_names, device=a.device, audio_out_sr=a.audio_out_sr,
        audio_gl_iters=a.audio_gl_iters, warm_audio=a.warm_audio, artifact=a.artifact, mesh=mesh)


if __name__ == "__main__":
    main()
