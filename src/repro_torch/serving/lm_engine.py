"""Static-batch LM serving engine: batched prefill, lockstep decode, greedy
or temperature sampling, EOS / max-token stopping.

The prefill runs the model's full-sequence pass (the attention or scan
kernel, once per mixer layer); each decode step runs plain tensor code
against the caches, which it updates in place.  Temperature sampling draws
from a `torch.Generator` seeded with `SamplerConfig.seed`: the tokens are
not the JAX engine's, whose draws come from `jax.random`; greedy tokens are
the same function of the logits (argmax, lowest index on ties).

A model whose state is sharded (`repro_torch.parallel.fsdp.shard_model` on
a ("data", "model") mesh) serves on every rank of its group: each rank
calls `generate` with the same global prompts and runs its rows
(`rank_rows`; every row where the data axis does not divide the batch),
the model's prefill and decode steps gathering its weights and running its
layers on their blocks, and its MoE layers dispatching the groups of the
whole batch (`Transformer.data_split`: a group whose rows lie on several
ranks is dispatched with its choices gathered over them).  Each step's f32 logits rows are gathered along
"data" to [B, V], and every rank samples from them with the same
`torch.Generator`: every rank returns the same completions, which are the
one-device engine's for the same logits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import make_rules, rank_rows


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
    `decode_steps` (the later tokens, one step each); and the bytes the
    rank put on the wire (`fsdp.WIRE`, reset at each call), by mesh axis and
    kind: `wire_prefill` of the model's prefill, `wire_decode_steps` of each
    decode step, `wire_logits` of the engine's gathers of the logits rows,
    `collective_s`, the host seconds of all of them by axis, and
    `wire_sites`, the bytes, calls and host seconds of the named sites
    summed over the call (the MoE choices' all-gathers of a dispatch group
    that spans ranks; all empty on a whole model)."""

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
        rows = self._rows(B)
        ranks = B // len(rows)  # the data-parallel ranks that share the rows
        # the rank's place in the prompts' and in a step's MoE dispatch groups
        prefill_split, step_split = self.model.data_split(B, plen), self.model.data_split(B, 1)
        gen = torch.Generator(device=self.device).manual_seed(self.sampler.seed)
        wire = {"wire_prefill": {}, "wire_decode_steps": [], "wire_logits": 0.0,
                "collective_s": {}, "wire_sites": {}}
        t0 = time.perf_counter()
        toks = torch.tensor(prompts, dtype=torch.int64, device=self.device)[rows.start:rows.stop]
        fsdp.WIRE.reset()
        logits, caches = self.model.prefill({"tokens": toks}, max_len=self.max_len,
                                            data_split=prefill_split)
        wire["wire_prefill"] = self._read_wire(wire)
        next_tok = self._sample(self._whole_rows(logits, ranks, wire), gen)
        out = [[tok] for tok in next_tok.tolist()]
        t1 = time.perf_counter()
        done = [False] * B
        position = plen
        steps = 0
        for _ in range(1, self.sampler.max_new_tokens):
            if position >= self.max_len or all(done):
                break
            fsdp.WIRE.reset()
            logits, caches = self.model.decode_step(caches, next_tok[rows.start:rows.stop],
                                                    position, data_split=step_split)
            wire["wire_decode_steps"].append(self._read_wire(wire))
            next_tok = self._sample(self._whole_rows(logits, ranks, wire), gen)
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
                      "decode_steps": steps, "batch": B, "prompt_len": plen, **wire}
        return out

    def _rows(self, B: int) -> range:
        """The rows of a batch of B that this rank runs (all on a whole model)."""
        sharding = self.model.fsdp
        if sharding is None:
            return range(B)
        return rank_rows(B, sharding.mesh, make_rules(sharding.mesh), sharding.rank)

    def _whole_rows(self, logits: torch.Tensor, ranks: int, wire: dict) -> torch.Tensor:
        """The rank's f32 logits rows gathered along "data" to [B, V] (its
        own where it runs every row), the gather's wire bytes added to
        `wire`."""
        logits = logits.float()
        if ranks == 1:
            return logits
        fsdp.WIRE.reset()
        whole = fsdp.gather_blocks([logits.contiguous()], [0], ranks,
                                   self.model.fsdp.data_group, "data")[0]
        wire["wire_logits"] += fsdp.WIRE.total
        self._read_wire(wire)
        return whole

    @staticmethod
    def _read_wire(wire: dict) -> dict:
        """`fsdp.WIRE`'s bytes by axis and kind since its reset; its host
        seconds added to wire["collective_s"] by axis, and its sites'
        readings to wire["wire_sites"]."""
        for axis, kinds in fsdp.WIRE.by_axis("seconds").items():
            wire["collective_s"][axis] = wire["collective_s"].get(axis, 0.0) + sum(kinds.values())
        for site, seen in fsdp.WIRE.by_site().items():
            mine = wire["wire_sites"].setdefault(site, dict.fromkeys(seen, 0))
            for k, v in seen.items():
                mine[k] += v
        return fsdp.WIRE.by_axis()

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.sampler.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.sampler.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
