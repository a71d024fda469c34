"""Entry point: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Set-up time is
counted from here, before the heavy imports."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402


def main() -> None:
    from portbench.harness import main as harness_main

    sys.exit(harness_main(sys.argv[1:], t_start=T_START))


if __name__ == "__main__":
    main()
