"""CLI for the port's static-analysis subsystem (port of
``repro/analysis/__main__.py``).

Usage::

    python -m repro_torch.analysis --check        # kernels + lint
    python -m repro_torch.analysis --kernels      # contract checker only
    python -m repro_torch.analysis --lint         # serving-hazard linter
    python -m repro_torch.analysis --lint --update-baseline
    python -m repro_torch.analysis --list         # kernel families
    python -m repro_torch.analysis --kernels --card   # + describe/sentinel

Exit status is 0 iff every selected analysis is clean.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _repo_src() -> str:
    # src/repro_torch/analysis/__main__.py -> src
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def run_kernels(args) -> int:
    from repro_torch.analysis import kernels

    names = args.kernel or None
    t0 = time.time()
    stats = {}
    findings = kernels.check_kernels(names, target=args.target,
                                     card=args.card, stats=stats)
    dt = time.time() - t0
    fams = names or kernels.registered_kernels()
    for f in findings:
        print(f"KERNEL {f.kernel}/{f.case}: [{f.check}] {f.message}")
    where = " on the card (describe + sentinel)" if args.card else ""
    print(
        f"kernel contracts{where}: {len(fams)} families "
        f"({', '.join(fams)}), {stats.get('cases', 0)} cases, "
        f"{len(findings)} finding(s) in {dt:.1f}s"
    )
    return 1 if findings else 0


def run_lint(args) -> int:
    from repro_torch.analysis import lint

    roots = args.path or [os.path.join(_repo_src(), "repro_torch")]
    baseline = lint.load_baseline()
    findings = lint.lint_paths(roots, baseline=None)

    if args.update_baseline:
        with open(lint.baseline_path(), "w", encoding="utf-8") as f:
            f.write(lint.format_baseline(findings))
        print(
            f"lint baseline: wrote {len(findings)} entrie(s) to "
            f"{lint.baseline_path()}"
        )
        return 0

    fresh = [f for f in findings if f.baseline_key() not in baseline]
    for f in fresh:
        print(f"LINT {f}")
    suppressed = len(findings) - len(fresh)
    note = f" ({suppressed} baselined)" if suppressed else ""
    print(f"lint: {len(fresh)} finding(s){note} over {len(roots)} root(s)")
    return 1 if fresh else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kernel-contract checker + serving-hazard linter",
    )
    p.add_argument("--check", action="store_true",
                   help="run kernels + lint")
    p.add_argument("--kernels", action="store_true",
                   help="run the kernel-contract checker")
    p.add_argument("--lint", action="store_true",
                   help="run the serving-hazard linter")
    p.add_argument("--list", action="store_true",
                   help="list registered kernel families and exit")
    p.add_argument("--kernel", action="append", metavar="NAME",
                   help="restrict --kernels to NAME (repeatable)")
    p.add_argument("--target", default="h100", choices=("h100",),
                   help="shared-memory budget target (h100: 232448 bytes "
                        "a block)")
    p.add_argument("--card", action="store_true",
                   help="add the describe and sentinel checks on the CUDA "
                        "card (raises without one)")
    p.add_argument("--path", action="append", metavar="DIR",
                   help="lint root(s); default src/repro_torch")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the lint baseline with current findings")
    args = p.parse_args(argv)

    if args.list:
        from repro_torch.analysis import kernels

        for name in kernels.registered_kernels():
            print(name)
        return 0

    if not (args.check or args.kernels or args.lint):
        args.check = True

    status = 0
    if args.check or args.lint:
        status |= run_lint(args)
    if args.check or args.kernels:
        status |= run_kernels(args)
    return status


if __name__ == "__main__":
    sys.exit(main())
