"""o1vm command-line interface (o1vm/src/cli/{mod,cannon}.rs analogue).

Counterpart of proof_systems_tpu/o1vm/cli.py: it runs the Cannon VM on the
host and proves nothing.

Usage:
    python -m proof_systems_tpu_torch.o1vm.cli cannon run \
        --input state.json --output out.json [--meta meta.json] \
        [--stop-at FREQ] [--info-at FREQ] [--snapshot-state-at FREQ] \
        [--snapshot-fmt state-%d.json] [--halt-address HEX] \
        [host_program args...]

FREQ formats (cannon.rs:146-190): never | always | =n | %n | n..[m].
The optional trailing host program is spawned as the preimage-oracle
server with the Cannon fd convention (hints on 3/4, preimages on 5/6).
"""

from __future__ import annotations

import argparse
import sys

from .cannon import CannonVM, Meta, PreImageOracle, State, StepFrequency


def _freq(s: str) -> StepFrequency:
    return StepFrequency.parse(s)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="o1vm")
    sub = parser.add_subparsers(dest="command", required=True)
    cannon = sub.add_parser("cannon", help="Cannon MIPS zkVM")
    csub = cannon.add_subparsers(dest="subcommand", required=True)
    run = csub.add_parser("run", help="run a Cannon state snapshot")
    run.add_argument("--input", default="state.json", help="initial state file")
    run.add_argument("--output", default="out.json", help="output state file")
    run.add_argument("--meta", default=None, help="metadata (symbols) file")
    run.add_argument("--stop-at", type=_freq, default=StepFrequency.parse("never"))
    run.add_argument("--info-at", type=_freq, default=StepFrequency.parse("never"))
    run.add_argument(
        "--snapshot-state-at", type=_freq, default=StepFrequency.parse("never")
    )
    run.add_argument("--snapshot-fmt", default="state-%d.json")
    run.add_argument("--halt-address", type=lambda s: int(s, 0), default=None)
    run.add_argument("--max-steps", type=int, default=None)
    run.add_argument("host", nargs=argparse.REMAINDER, help="preimage host program")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    state = State.load(args.input)
    meta = Meta.load(args.meta) if args.meta else None
    oracle = None
    if args.host:
        oracle = PreImageOracle(args.host[0], args.host[1:])
        oracle.start()
    try:
        vm = CannonVM(state, oracle=oracle, meta=meta)
        vm.run(
            stop_at=args.stop_at,
            info_at=args.info_at,
            snapshot_at=args.snapshot_state_at,
            snapshot_fmt=args.snapshot_fmt,
            halt_address=args.halt_address,
            max_steps=args.max_steps,
        )
    finally:
        if oracle is not None:
            oracle.close()
    state.save(args.output)
    print(f"step={state.step} pc={state.pc:#x} exited={state.exited} exit={state.exit}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
