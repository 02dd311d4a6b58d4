"""Command-line interface: ``benchmark`` and ``convergence``.

Written with ``argparse`` so that it needs nothing beyond the standard
library, torch and numpy. Run it as ``python -m lettuce_tpu_torch.cli`` or
as the ``lettuce-tpu-torch`` script. The global options may stand before or
after the subcommand::

    python -m lettuce_tpu_torch.cli benchmark -r 256 -s 100 -f taylor3d \\
        --device cuda -p single
    python -m lettuce_tpu_torch.cli benchmark -r 256 -s 100 -f taylor3d \\
        -p single --half-storage
    python -m lettuce_tpu_torch.cli --device cuda convergence

``--device cuda`` without a card is an error: nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
from timeit import default_timer as timer

import torch

import lettuce_tpu_torch as lt

_PRECISIONS = {"half": torch.bfloat16, "single": torch.float32,
               "double": torch.float64}


def _add_global_options(parser: argparse.ArgumentParser, suppress: bool):
    """The options shared by every subcommand. On a subcommand they default
    to SUPPRESS, so that a value given before the subcommand stands."""
    def default(value):
        return argparse.SUPPRESS if suppress else value

    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default=default("cuda"),
                        help="Device to run on (default cuda; cuda without "
                             "a card is an error).")
    parser.add_argument("-p", "--precision", choices=sorted(_PRECISIONS),
                        default=default("double"),
                        help="bfloat16, float32 or float64 state (default "
                             "double; the CUDA kernels run all three, a "
                             "bfloat16 state computing in float32).")
    parser.add_argument("--use-native", dest="use_native",
                        action="store_true", default=default(True),
                        help="Use the fused CUDA stream-collide kernel "
                             "(default).")
    parser.add_argument("--use-no-native", dest="use_native",
                        action="store_false", default=default(True),
                        help="Run the plain torch step.")
    parser.add_argument("-i", "--device-id", type=int,
                        default=default(None),
                        help="CUDA device index on a multi-card host.")
    # aliases of the lettuce_tpu CLI's flags
    parser.add_argument("--cuda", dest="device", action="store_const",
                        const="cuda", default=default("cuda"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--no-cuda", dest="device", action="store_const",
                        const="cpu", default=default("cuda"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--gpu-id", dest="device_id", type=int,
                        default=default(None), help=argparse.SUPPRESS)
    parser.add_argument("--use-cuda_native", dest="use_native",
                        action="store_true", default=default(True),
                        help=argparse.SUPPRESS)
    parser.add_argument("--use-no-cuda_native", dest="use_native",
                        action="store_false", default=default(True),
                        help=argparse.SUPPRESS)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lettuce-tpu-torch",
        description="lettuce_tpu_torch: the PyTorch/CUDA lattice Boltzmann "
                    "port.")
    parser.add_argument("--version", action="version",
                        version=f"lettuce-tpu-torch {lt.__version__}")
    _add_global_options(parser, suppress=False)
    sub = parser.add_subparsers(dest="command", required=True)

    bench = sub.add_parser("benchmark", help="Run a short simulation and "
                                             "print the throughput in MLUPS.")
    bench.add_argument("-s", "--steps", type=int, default=10,
                       help="Number of simulation steps.")
    bench.add_argument("-r", "--resolution", type=int, default=1024,
                       help="Grid points per dimension.")
    bench.add_argument("-f", "--flow", dest="flow_name", default="taylor2d",
                       choices=sorted(lt.flow_by_name))
    bench.add_argument("--profile-out", type=str, default="",
                       help="File to write cProfile results to.")
    bench.add_argument("--half-storage", action="store_true",
                       help="Keep the state as bfloat16 deviations from "
                            "the equilibrium weights between steps (half "
                            "the memory traffic, float32 compute; needs "
                            "the CUDA kernel path).")
    _add_global_options(bench, suppress=True)

    conv = sub.add_parser("convergence", help="TGV2D diffusive-scaling "
                                              "order check; exits 1 on "
                                              "failure.")
    conv.add_argument("--max-resolution-exponent", type=int, default=8)
    _add_global_options(conv, suppress=True)
    return parser


def _context(args) -> "lt.Context":
    device = args.device
    if args.device_id is not None:
        if device != "cuda":
            raise SystemExit("error: --device-id selects a CUDA device")
        if not torch.cuda.is_available():
            raise SystemExit("error: --device cuda was requested, but no "
                             "CUDA device is available")
        count = torch.cuda.device_count()
        if not 0 <= args.device_id < count:
            raise SystemExit(f"error: device id {args.device_id} out of "
                             f"range: {count} device(s) available")
        device = f"cuda:{args.device_id}"
    elif device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --device cuda was requested, but no CUDA "
                         "device is available")
    return lt.Context(device=device, dtype=_PRECISIONS[args.precision],
                      use_native=args.use_native)


def benchmark(context, steps, resolution, flow_name, profile_out="",
              half_storage=False):
    """Run a short simulation and print the throughput in MLUPS, the step
    path and whether half storage engaged."""
    if profile_out:
        profile = cProfile.Profile()
        profile.enable()

    flow_class, stencil = lt.flow_by_name[flow_name]
    if flow_name == "decay2d":
        flow = flow_class(context, [resolution] * 2, 10000, 0.05, randseed=0)
    else:
        flow = flow_class(context, resolution, 10000, 0.05,
                          stencil=stencil())
    # a flow with a body force gets Guo forcing, as lettuce_tpu's CLI does
    force = None
    if hasattr(flow, "acceleration"):
        force = lt.Guo(flow, tau=flow.units.relaxation_parameter_lu,
                       acceleration=flow.units.convert_acceleration_to_lu(
                           flow.acceleration))
    collision = lt.BGKCollision(tau=flow.units.relaxation_parameter_lu,
                                force=force)
    simulation = lt.Simulation(flow, collision, [],
                               half_storage=half_storage)
    mlups = simulation(steps)

    if profile_out:
        profile.disable()
        stats = pstats.Stats(profile)
        stats.sort_stats("cumulative")
        stats.dump_stats(profile_out)
        print(f"profile written to {profile_out}")

    dtype = str(context.dtype).removeprefix("torch.")
    storage = ("on (bfloat16 deviations)" if simulation.half_storage_engaged
               else "off")
    print(f"Finished {steps} steps in {dtype} on {context.device} "
          f"({simulation.step_path} path), half storage {storage}. MLUPS: "
          f"{mlups:10.2f}")
    return mlups


def convergence(context, max_resolution_exponent) -> int:
    """TGV2D diffusive-scaling order check: per-step errors at interval=1
    averaged over the run, resolutions 2^4..2^max, gated on the final
    refinement factor (u order in [1.9, 2.1], p order in [0.9, 1.1]).
    Returns 1 on failure, 0 on success."""
    error_u_old = error_p_old = None
    factor_u = factor_p = 0.0
    print(("{:>15} " * 6).format("resolution", "error (u)", "order (u)",
                                 "error (p)", "order (p)", "MLUPS"))
    for e in range(4, max_resolution_exponent + 1):
        resolution = 2 ** e
        mach_number = 8 / resolution
        flow = lt.TaylorGreenVortex(context, [resolution] * 2,
                                    reynolds_number=10000,
                                    mach_number=mach_number,
                                    stencil=lt.D2Q9())
        simulation = lt.Simulation(
            flow, lt.BGKCollision(tau=flow.units.relaxation_parameter_lu),
            [])
        num_steps = 10 * resolution
        beg = timer()
        error_u, error_p = lt.mean_analytic_error(simulation, num_steps)
        mlups = num_steps * resolution ** 2 / 1e6 / (timer() - beg)

        factor_u = 0 if error_u_old is None else error_u_old / error_u
        factor_p = 0 if error_p_old is None else error_p_old / error_p
        error_u_old, error_p_old = error_u, error_p
        print(f"{resolution:15} {error_u:15.2e} {factor_u / 2:15.2f} "
              f"{error_p:15.2e} {factor_p / 2:15.2f} {mlups:15.2f}")

    tol = 1e-1
    if not (2 - tol) < factor_u / 2 < (2 + tol):
        print(f"FAILED: Velocity convergence order {factor_u / 2} is not "
              f"in [1.9, 2.1].")
        return 1
    if not (1 - tol) < factor_p / 2 < (1 + tol):
        print(f"FAILED: Pressure convergence order {factor_p / 2} is not "
              f"in [0.9, 1.1].")
        return 1
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    context = _context(args)
    if args.command == "benchmark":
        benchmark(context, args.steps, args.resolution, args.flow_name,
                  args.profile_out, args.half_storage)
        return 0
    return convergence(context, args.max_resolution_exponent)


if __name__ == "__main__":
    sys.exit(main())
