"""Training launcher: the counterpart of ``python -m ditl_tpu.launch``.

    python -m ditl_tpu_torch.launch --preset llama3-8b \\
        model.param_dtype=bfloat16 model.attention_impl=flash \\
        model.loss_impl=fused model.remat=full train.optimizer=adafactor \\
        data.synthetic=true data.batch_size=4 data.seq_len=2048 train.total_steps=6

Runs ``train/trainer.py::train`` on one card (``--device cuda``, the
default; ``--device cpu`` runs it on the CPU) and prints the summary JSON as
the last line of stdout. Overrides are ``section.key=value`` over the
``model``, ``data`` and ``train`` sections, with ``model.name=<preset>``
applied first as in the JAX launcher. With ``train.checkpoint_dir`` set it
saves every ``train.checkpoint_every`` steps and at the end, and a second
run of the same command resumes from the newest verified step
(``train.resume``, default true); ``data.eval_fraction`` with
``train.val_every`` reports a held-out ``val_loss``. ``--simulate``,
``--distributed``, ``--supervise``, ``--pod`` and the rendezvous flags belong
to the multi-GPU slice and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ditl_tpu_torch.config import Config, parse_overrides
from ditl_tpu_torch.models.presets import PRESETS, get_preset

__all__ = ["build_config", "main"]

_MULTI_GPU = ("--simulate", "--distributed", "--supervise", "--pod", "--coordinator",
              "--num-processes", "--process-id")


def build_config(argv: list[str] | None = None) -> tuple[Config, str]:
    """(config, device) from the command line."""
    parser = argparse.ArgumentParser(
        prog="ditl_tpu_torch.launch",
        description="fine-tune on one CUDA card (the PyTorch port)",
        allow_abbrev=False,
    )
    parser.add_argument("--preset", default=None, help="model preset name")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--print-config", action="store_true")
    for flag in _MULTI_GPU:
        parser.add_argument(flag, default=None, nargs="?", const=True,
                            help=argparse.SUPPRESS)
    parser.add_argument("overrides", nargs="*",
                        help="config overrides like train.total_steps=50")
    args = parser.parse_args(argv)
    given = [f for f in _MULTI_GPU if getattr(args, f.lstrip("-").replace("-", "_"))]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: multi-process and multi-GPU training is the "
            "multi-GPU slice of the port, not ported yet (see ROADMAP.md)")
    config = Config()
    if args.preset:
        config = dataclasses.replace(config, model=get_preset(args.preset))
    # model.name=<preset> swaps in the preset first, so later model.*
    # overrides layer on top of it.
    for item in args.overrides:
        if item.startswith("model.name=") and item.split("=", 1)[1] in PRESETS:
            config = dataclasses.replace(config, model=get_preset(item.split("=", 1)[1]))
    config = parse_overrides(config, args.overrides)
    if args.print_config:
        print(config.to_json())
        sys.exit(0)
    return config, args.device


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "gateway":
        raise NotImplementedError("the serving gateway is not ported to PyTorch "
                                  "yet (see ROADMAP.md)")
    config, device = build_config(argv)
    from ditl_tpu_torch.train.trainer import train

    try:
        summary = train(config, device=device)
    except Exception:
        import logging

        logging.getLogger(__name__).exception("training failed")
        return 1
    print(json.dumps(summary, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
