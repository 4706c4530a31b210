"""Serving launcher: batched autoregressive decode of a language model (port
of the JAX package's ``launch/serve.py``).

It prefills by stepping the prompt through ``Model.decode_step`` (as the
JAX launcher does), then generates ``--gen`` tokens, greedy or with
temperature sampling, and prints the prefill seconds and the decode
tokens/s. Weights are random, from the port's own init on a seeded
``torch.Generator``; the prompt comes from ``numpy.random.default_rng(0)``,
as in the JAX launcher. An encoder-decoder (whisper-tiny) first draws its
stub frames from the same generator, before the prompt, and fills the
cross cache from them (``Model.prefill_cross``). The full-sequence prefill
entry is ``Model.prefill_logits``.

Example (any id of ``repro_torch.configs.list_archs()``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models.model import Model, build_model
from repro_torch.utils.device import resolve_device


def split_generator(seed: int, device: torch.device
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """Two independent streams from one seed, as the JAX launcher splits its
    key before ``model.init``: (the init's, the sampler's). The sampler
    never reuses the stream the init consumed."""
    root = torch.Generator().manual_seed(seed)
    init_seed, sample_seed = torch.randint(0, 2 ** 62, (2,),
                                           generator=root).tolist()
    return (torch.Generator(device=device).manual_seed(init_seed),
            torch.Generator(device=device).manual_seed(sample_seed))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, params, prompt: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             frames: Optional[torch.Tensor] = None) -> Dict[str, object]:
    """Prefill ``prompt`` (B, P) through the decode cache, then generate
    ``gen`` tokens; an encoder-decoder's cross cache is filled from
    ``frames`` first. Returns ``{"tokens": (B, gen + 1) int64 numpy,
    "prefill_s", "decode_s", "decode_tok_s"}``; the first generated token
    is the prefill's argmax, as in the JAX launcher."""
    batch, prompt_len = prompt.shape
    device = model.device
    cache = model.init_cache(batch, prompt_len + gen)
    with torch.no_grad():
        if frames is not None:
            cache = model.prefill_cross(params, cache, frames)
        t0 = time.perf_counter()
        logits = None
        for i in range(prompt_len):
            logits, cache = model.decode_step(params, cache,
                                              prompt[:, i:i + 1], i)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out: List[torch.Tensor] = [tok]
        t0 = time.perf_counter()
        for g in range(gen):
            logits, cache = model.decode_step(params, cache, tok,
                                              prompt_len + g)
            if temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / temperature,
                                      dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        _sync(device)
        t_gen = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1).cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_gen,
            "decode_tok_s": batch * gen / t_gen if gen else 0.0}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = smoke_variant(arch.model) if args.smoke else arch.model
    model = build_model(cfg, device)
    rng = np.random.default_rng(0)
    init_gen, sample_gen = split_generator(0, device)
    params = model.init(init_gen)
    frames = None
    if cfg.is_encdec:  # drawn before the prompt, as in the JAX launcher
        frames = torch.from_numpy(rng.normal(
            size=(args.batch, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32)).to(device)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)

    res = generate(model, params, prompt, args.gen,
                   temperature=args.temperature, generator=sample_gen,
                   frames=frames)
    print(f"prefill: {args.prompt_len} steps in {res['prefill_s']:.2f}s; "
          f"decode: {res['decode_tok_s']:.1f} tok/s")
    print("generated token ids (first row):", res["tokens"][0].tolist())
    return res


if __name__ == "__main__":
    main()
