"""Generate the port's CLI flag reference (docs/cli_reference_torch.md) from
the live argparse parsers — the docs cannot drift from the code because they
ARE the code's --help output.

The port's copy of :mod:`tcgan_tpu.utils.cli_docs`: the same page for the
same 16 entry points under their ``tcgan_torch`` names (the reference's
page, docs/cli_reference.md, is the flag contract they follow).

Reference parity note: the reference documents its flag family only via
--help per script (SURVEY.md §5.6); this collects the same surface into
one browsable page for all entry points.

Usage:
    python -m tcgan_torch.utils.cli_docs [-o docs/cli_reference_torch.md]
"""

from __future__ import annotations

import argparse
import importlib
import sys

# (module, blurb) — every user-facing entry point with a make_parser()
ENTRY_POINTS = (
    ("tcgan_torch.run.forward", "C1: forward solve + TC sweep / serving"),
    ("tcgan_torch.run.gan", "C2: WGAN-GP, implicit-diff gradients"),
    ("tcgan_torch.run.bptt_wgan", "C3: WGAN-GP, BPTT through the Euler scan"),
    ("tcgan_torch.run.bptt_cwgan", "C4: conditional WGAN"),
    ("tcgan_torch.run.moments", "C5: moment matching"),
    ("tcgan_torch.run.bptt_moments", "C5 (BPTT solver variant)"),
    ("tcgan_torch.run.ensemble", "multi-start ensemble fitting"),
    ("tcgan_torch.run.eval", "post-hoc fit evaluation (W1, recovery)"),
    ("tcgan_torch.analysis.identifiability", "battery design / CRLB"),
    ("tcgan_torch.analysis.uncertainty", "endpoint error bars + calibration"),
    ("tcgan_torch.analysis.learning_curves", "learning-curve figures"),
    ("tcgan_torch.analysis.compare", "multi-run comparison"),
    ("tcgan_torch.analysis.fit_quality", "one-page fit report figure"),
    ("tcgan_torch.analysis.ensemble_view", "ensemble spread vs spectrum"),
    ("tcgan_torch.analysis.report", "one-command markdown run report"),
    ("tcgan_torch.analysis.recovery_gate",
     "exit-code recovery gate for unattended orchestration"),
)


def render() -> str:
    import os

    # argparse wraps help text to the terminal width — pin it so the
    # generated file (and the freshness test) is environment-independent
    os.environ["COLUMNS"] = "80"
    out = [
        "# CLI reference",
        "",
        "Auto-generated from the live argparse parsers — regenerate with",
        "`make docs-torch` (or `python -m tcgan_torch.utils.cli_docs`). Do not",
        "edit by hand.",
        "",
    ]
    for mod_name, blurb in ENTRY_POINTS:
        mod = importlib.import_module(mod_name)
        parser = mod.make_parser()
        parser.prog = f"python -m {mod_name}"
        out += [f"## `{mod_name}` — {blurb}", "", "```text",
                parser.format_help().rstrip(), "```", ""]
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--output", default="docs/cli_reference_torch.md")
    args = p.parse_args(argv)
    text = render()
    with open(args.output, "w") as fh:
        fh.write(text)
    print(f"wrote {args.output} ({len(text.splitlines())} lines, "
          f"{len(ENTRY_POINTS)} entry points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
