"""Generation serving CLI: load a DDPM checkpoint, serve batched requests.

A dynamic-batching HTTP service around the sampler: concurrent
POST /generate requests coalesce into fixed-shape reverse-diffusion chains
(see serving/server.py).

  python -m spectrogramgenai_tpu_torch.cli.serve --run.run_name ddpm \\
      --vqae_ckpt models/vqvae --port 8000 --serve_batch 27 \\
      --train_folder_for_classes datasets/train

Default sampler is DPM-Solver++(2M) at 20 steps; pass --sampler ddim
--num_steps 50 (or ddpm for the 999-step chain) to override. Runs on CUDA
unless --device says otherwise.

  curl -X POST localhost:8000/generate -d '{"label": "bird_a", "count": 2}'
  curl localhost:8000/stats
"""

from __future__ import annotations

import argparse


def run(cfg, *, port: int, host: str = "127.0.0.1", serve_batch: int = 27,
        max_delay_ms: float = 50.0, sampler: str = "dpmpp", num_steps: int = 20,
        use_ema: bool = False, class_names: list[str] | None = None, warmup: bool = True,
        block: bool = True, device: str = "cuda"):
    from spectrogramgenai_tpu_torch.cli.common import load_task, resolve_device
    from spectrogramgenai_tpu_torch.serving import BatchingSampler, GenerationHTTPServer

    task = load_task(cfg, resolve_device(device), use_ema=use_ema)
    batcher = BatchingSampler(task, batch_size=serve_batch, max_delay_ms=max_delay_ms,
                              sampler=sampler, num_steps=num_steps, seed=cfg.run.seed)
    if warmup:
        # one chain before accepting traffic: builds the kernels, warms the allocator
        print(f"serve: warming up ({sampler}, batch {serve_batch})…", flush=True)
        batcher.submit(0, 1).result()
        print("serve: warmup done", flush=True)

    server = GenerationHTTPServer(batcher, class_names, host=host, port=port)
    print(f"serve: listening on {host}:{server.port} "
          f"(batch {serve_batch}, window {max_delay_ms}ms, {sampler}, {task.device})", flush=True)
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            batcher.close()
    else:
        server.start()  # background handler thread; caller owns shutdown()
    return server, batcher


def main(argv=None):
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
    p.add_argument("--train_folder_for_classes", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for tests)")
    add_config_args(p, DDPMConfig)
    a = p.parse_args(argv)
    cfg = apply_overrides(DDPMConfig(), a)

    if a.train_folder_for_classes:
        from spectrogramgenai_tpu_torch.data.manifest import class_names_from_folder

        class_names = class_names_from_folder(a.train_folder_for_classes)
    else:
        class_names = [f"class{i:02d}" for i in range(cfg.num_classes)]

    num_steps = a.num_steps if a.num_steps else (20 if a.sampler == "dpmpp" else 50)
    run(cfg, port=a.port, host=a.host, serve_batch=a.serve_batch,
        max_delay_ms=a.max_delay_ms, sampler=a.sampler, num_steps=num_steps,
        use_ema=bool(a.use_ema), class_names=class_names, device=a.device)


if __name__ == "__main__":
    main()
