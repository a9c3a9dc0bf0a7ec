"""The one traffic generator: reads a mix's parameters from its data file.

A mix is a JSON file under ``portbench/traffic/``; its ``kind`` says what
it drives.  Every draw is made on the device from the run's ``--seed``, in
the same order on every replay, so the reference can draw the same
batches again after the window.  The sizes of a batch never depend on the
seed: every seed gives the same work, in another order.

``store``: closed-loop batches of ``batch`` operations over the
configuration's ``record_count`` records.  ``mix`` gives each operation's
share (``read``, ``update``); a batch holds exactly that many of each, its
reads served before its updates.  ``distribution`` (``zipfian`` with
``theta``, or ``uniform``) draws the record ids; ``miss_share`` of the
reads ask for absent keys instead.

``serve``: closed-loop groups of ``group`` requests, each a prompt of
``prompt_len`` token ids drawn uniformly from the vocabulary, served
``output_tokens`` greedy tokens.
"""

from __future__ import annotations

import torch

from portbench import ycsb

STREAMS = {"records": 1, "requests": 2, "check": 3, "weights": 4}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A device generator for one named stream of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + STREAMS[stream]) % 2 ** 63)
    return g


class StoreTraffic:
    """Batches of a ``store`` mix: ``next()`` -> dict of device tensors."""

    def __init__(self, spec: dict, config: dict, seed: int, device):
        if spec["kind"] != "store":
            raise ValueError(f"not a store mix: {spec['kind']!r}")
        mix = spec["mix"]
        if set(mix) - {"read", "update"} or abs(sum(mix.values()) - 1) > 1e-9:
            raise ValueError(f"a store mix takes read and update shares "
                             f"summing to 1: {mix}")
        self.batch = int(spec["batch"])
        self.n_read = round(self.batch * mix.get("read", 0.0))
        self.n_update = self.batch - self.n_read
        self.n_miss = round(self.n_read * spec.get("miss_share", 0.0))
        self.records = int(config["record_count"])
        self.device = device
        self.dist = ycsb.distribution(spec["distribution"], self.records,
                                      device, spec.get("theta", 0.99))
        self.seed = seed
        self.restart()

    def restart(self) -> None:
        """Draw the same batches again, from the first."""
        self.gen = generator(self.seed, "requests", self.device)

    def next(self) -> dict:
        g, out = self.gen, {}
        if self.n_read:
            ids = self.dist.sample(g, self.n_read - self.n_miss)
            if self.n_miss:
                ids = torch.cat([ids, ycsb.negative_ids(g, self.records,
                                                        self.n_miss)])
                ids = ids[torch.randperm(self.n_read, generator=g,
                                         device=g.device)]
            out["read_keys"] = ycsb.make_key(ids)
        if self.n_update:
            out["update_keys"] = ycsb.make_key(self.dist.sample(
                g, self.n_update))
            out["update_vals"] = ycsb.make_value(g, self.n_update)
        return out


class ServeTraffic:
    """Groups of a ``serve`` mix: ``next()`` -> (group, prompt_len) int32
    prompts."""

    def __init__(self, spec: dict, vocab: int, seed: int, device):
        if spec["kind"] != "serve":
            raise ValueError(f"not a serve mix: {spec['kind']!r}")
        self.group = int(spec["group"])
        self.prompt_len = int(spec["prompt_len"])
        self.output_tokens = int(spec["output_tokens"])
        self.vocab, self.seed, self.device = vocab, seed, device
        self.restart()

    def restart(self) -> None:
        self.gen = generator(self.seed, "requests", self.device)

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, (self.group, self.prompt_len),
                             generator=self.gen, device=self.device,
                             dtype=torch.int32)
