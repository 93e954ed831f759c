"""CLI entry: ``python -m repro_torch.obs report [--dir ...] [--timeline]``."""
import sys

from . import report


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "report":
        print("usage: python -m repro_torch.obs report [--dir DIR] "
              "[--timeline]", file=sys.stderr)
        return 2
    return report.main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
