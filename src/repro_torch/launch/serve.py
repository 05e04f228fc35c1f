"""Serving launcher of the port: paged continuous batching on the card.

``python -m repro_torch.launch.serve`` takes the JAX launcher's flags for
the paths the port runs (``--arch --reduced --requests --max-new
--max-batch --shared-prefix --kv paged`` and every :class:`ServeConfig`
field) plus ``--device`` (default ``cuda``), builds the same seeded
requests, serves them through :class:`PagedEngine` and prints the same
``req …`` lines on stdout, so the two launchers' outputs can be diffed
when they serve the same weights (:func:`main` takes ``params=`` for
that).  Paged-engine statistics go to stderr.

Not ported yet: the dense ``--kv dense`` server, the async ``--server``
loop and the options :class:`PagedEngine` rejects.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 8 --max-new 32 --shared-prefix 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --device cpu --shared-prefix 24
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import DEFAULT, resolve
from repro_torch.models import lm
from repro_torch.serve import PagedEngine, Request, add_serve_args, get_sampler
from repro_torch.serve import config as serve_config


def make_requests(cfg, *, n: int, max_new: int, shared_prefix: int, seed: int):
    """The JAX launcher's request list, from the same numpy seed."""
    rng = np.random.default_rng(seed)
    prefix = list(rng.integers(0, cfg.vocab, size=shared_prefix))
    return [
        Request(rid=i,
                prompt=prefix + list(rng.integers(0, cfg.vocab, size=rng.integers(4, 12))),
                max_new=max_new)
        for i in range(n)
    ]


def print_request_lines(done: list[Request]) -> None:
    """stdout is the parity surface with the JAX launcher."""
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {len(r.out)} "
              f"tokens: {r.out[:8]}...")
    print(f"served {len(done)} requests with continuous batching")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--kv", choices=("paged",), default="paged",
                    help="KV-cache backend: the paged pool with prefix sharing "
                         "(the dense server is not ported yet)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common random prefix of this many tokens "
                         "to every request (exercises prefix sharing and the "
                         "chunked suffix prefill)")
    ap.add_argument("--device", default=DEFAULT,
                    help="torch device: cuda (the kernels) or cpu (their plain "
                         "versions)")
    # every ServeConfig knob becomes a flag, one definition (serve/config.py)
    add_serve_args(ap)
    return ap


def main(argv: list[str] | None = None, *, params=None) -> list[Request]:
    """Run the launcher; ``params`` (on the chosen device) replaces the
    seeded random init, e.g. weights converted by ``repro_torch.weights``."""
    args = parser().parse_args(argv)
    serve_cfg = serve_config.from_args(args, max_slots=args.max_batch)
    for flag, value in (("--trace", serve_cfg.trace), ("--queue-cap", serve_cfg.queue_cap)):
        if value is not None:
            raise NotImplementedError(f"{flag} is not ported yet")
    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve(args.device)
    if params is None:
        params = lm.init(cfg, seed=serve_cfg.seed, device=device)
    engine = PagedEngine(cfg, params, config=serve_cfg,
                         sampler=get_sampler(serve_cfg.sampler), device=device)
    reqs = make_requests(cfg, n=args.requests, max_new=args.max_new,
                         shared_prefix=args.shared_prefix, seed=serve_cfg.seed)
    done = engine.run(reqs)
    print_request_lines(done)
    print(f"# paged kv stats: {engine.stats()}", file=sys.stderr)
    return done


if __name__ == "__main__":
    main()
