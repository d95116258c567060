"""Static-batch LM serving engine: batched prefill, lockstep decode, greedy
or temperature sampling, EOS / max-token stopping.

The prefill runs the model's full-sequence pass (the attention or scan
kernel, once per mixer layer); each decode step runs plain tensor code
against the caches, which it updates in place.  Temperature sampling draws
from a `torch.Generator` seeded with `SamplerConfig.seed`: the tokens are
not the JAX engine's, whose draws come from `jax.random`; greedy tokens are
the same function of the logits (argmax, lowest index on ties).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 => greedy
    eos_id: int | None = None
    max_new_tokens: int = 32
    seed: int = 0


class ServeEngine:
    """Serves `model` (a `repro_torch.models.transformer.Transformer`, which
    holds its parameters) on `device`: None is the CUDA card, and a model on
    another device is refused, never moved.

    After each `generate`, `stats` holds its host-clock times: `prefill_s`
    (prefill and the first token, read back to the host), `decode_s` and
    `decode_steps` (the later tokens, one step each)."""

    def __init__(self, model, max_len: int, batch_size: int,
                 sampler: SamplerConfig = SamplerConfig(), *, device=None):
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"the model is on {model.device}, the engine on {dev}; build "
                             f"the model with device={str(dev)!r}")
        self.model = model
        self.device = dev
        self.max_len = max_len
        self.batch_size = batch_size
        self.sampler = sampler
        self.stats: dict = {}

    def generate(self, prompts: list[list[int]]) -> list[list[int]]:
        """Generate completions for up to batch_size prompts of equal length."""
        if not prompts or len(prompts) > self.batch_size:
            raise ValueError(f"need 1..{self.batch_size} prompts, got {len(prompts)}")
        plen = len(prompts[0])
        if any(len(p) != plen for p in prompts):
            raise ValueError("static engine: equal prompt lengths")
        B = len(prompts)
        gen = torch.Generator(device=self.device).manual_seed(self.sampler.seed)
        t0 = time.perf_counter()
        toks = torch.tensor(prompts, dtype=torch.int64, device=self.device)
        logits, caches = self.model.prefill({"tokens": toks}, max_len=self.max_len)
        next_tok = self._sample(logits, gen)
        out = [[tok] for tok in next_tok.tolist()]
        t1 = time.perf_counter()
        done = [False] * B
        position = plen
        steps = 0
        for _ in range(1, self.sampler.max_new_tokens):
            if position >= self.max_len or all(done):
                break
            logits, caches = self.model.decode_step(caches, next_tok, position)
            next_tok = self._sample(logits, gen)
            position += 1
            steps += 1
            for i, tok in enumerate(next_tok.tolist()):
                if done[i]:
                    continue
                if self.sampler.eos_id is not None and tok == self.sampler.eos_id:
                    done[i] = True
                else:
                    out[i].append(tok)
        self.stats = {"prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1,
                      "decode_steps": steps, "batch": B, "prompt_len": plen}
        return out

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.sampler.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.sampler.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
