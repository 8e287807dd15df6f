"""Serving CLI: fused prefill + continuous batching on the merged
global model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --batch 8 --prompt-len 128 --gen 32 --slots 8 --pages 512

Thin command line over :class:`repro_torch.api.ServeSpec` /
:func:`repro_torch.api.build_serve`: restores a federated training
checkpoint (or initialises from ``--seed``), warms up, serves the
request batch with continuous batching, and prints tokens/s plus
per-request latency percentiles. Runs on ``cuda`` unless ``--device``
says otherwise. ``--reference`` runs the token-by-token decode baseline
(:func:`generate`) instead -- the oracle the serving equivalence tests
compare against.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models import transformer as T


@torch.no_grad()
def generate(params, cfg, prompt_tokens: torch.Tensor, max_len: int,
             gen: int, temperature: float = 0.0, seed: int = 0,
             return_logits: bool = False):
    """Token-by-token reference path: the prompt goes through the decode
    step one token at a time, then ``gen`` tokens are sampled (greedy at
    ``temperature == 0``; otherwise from a generator seeded with
    ``seed``). prompt_tokens: (B, P) on the params' device.

    Returns the (B, P + gen) tokens and, with ``return_logits``, also the
    list of ``gen`` float32 (B, V) logits the generated tokens were
    sampled from.
    """
    B, P = prompt_tokens.shape
    device = prompt_tokens.device
    cache = T.init_decode_cache(cfg, B, max_len, device=device)
    generator = torch.Generator(device)
    generator.manual_seed(seed)
    tok = prompt_tokens[:, :1]
    gen_toks, logs = [], []
    for i in range(P + gen - 1):
        logits, cache = T.decode_step(params, {"tokens": tok}, cache, i, cfg)
        if i + 1 < P:
            tok = prompt_tokens[:, i + 1:i + 2]
            continue
        lg = logits[:, 0].float()
        if temperature > 0:
            tok = torch.multinomial(torch.softmax(lg / temperature, dim=-1),
                                    1, generator=generator)
        else:
            tok = lg.argmax(dim=-1, keepdim=True)
        gen_toks.append(tok)
        logs.append(lg)
    out = torch.cat([prompt_tokens] + gen_toks, dim=1)
    return (out, logs) if return_logits else out


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def main():
    from repro_torch.api import ServeSpec, build_serve
    from repro_torch.serve import Request

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8,
                    help="number of requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache length (0 = prompt-len + gen)")
    ap.add_argument("--pages", type=int, default=0,
                    help="page-pool size (0 = dense cache)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--static", action="store_true",
                    help="admission barrier (A/B against continuous)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-step", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", action="store_true",
                    help="token-by-token baseline instead of the engine")
    args = ap.parse_args()

    max_len = args.max_len or (args.prompt_len + args.gen)
    total_new = args.batch * args.gen
    spec = ServeSpec(
        arch=args.arch, reduced=args.reduced,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_step=args.checkpoint_step,
        slots=args.slots, max_len=max_len, pages=args.pages,
        page_size=args.page_size, temperature=args.temperature,
        seed=args.seed, admission="static" if args.static else "continuous",
        device=args.device)
    program = build_serve(spec)
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, program.cfg.vocab_size, (args.batch, args.prompt_len))

    if args.reference:
        toks = torch.as_tensor(prompts, device=program.engine.device)
        run = lambda p: generate(program.params, program.cfg, p, max_len,
                                 args.gen, temperature=args.temperature,
                                 seed=args.seed + 2)
        run(toks[:, :2])                      # warm up
        t0 = time.perf_counter()
        out = run(toks).cpu()
        dt = time.perf_counter() - t0
        print(f"[reference] generated {tuple(out.shape)} in {dt:.2f}s "
              f"({total_new / dt:.1f} tok/s batched)")
        print("sample row:", out[0, :32].tolist())
        return

    engine = program.engine
    engine.warmup([args.prompt_len])
    reqs = [Request(i, prompts[i], args.gen) for i in range(args.batch)]
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    dt = time.perf_counter() - t0
    lats = [r.latency for r in results.values()]
    print(f"[{spec.admission}] {args.batch} reqs x {args.gen} tok on "
          f"{spec.slots} slots"
          + (f" ({spec.pages}x{spec.page_size}-token pages)"
             if spec.pages else " (dense cache)")
          + f" on {engine.device}: {dt:.2f}s ({total_new / dt:.1f} tok/s, "
          f"latency p50={_percentile(lats, 50):.3f}s "
          f"p99={_percentile(lats, 99):.3f}s, "
          f"cache {engine.state_bytes() / 1e6:.1f} MB)")
    print("sample row:", results[0].tokens[:32].tolist())


if __name__ == "__main__":
    main()
