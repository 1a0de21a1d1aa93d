"""Multi-process deployment: the reference's ``deploy.py`` over ``torch.distributed``.

Counterpart of ``aggregathor_tpu/cli/deploy.py``.  The reference bootstraps
a TF server per node over SSH/mpirun and wires a ClusterSpec of
ps/worker/eval jobs (reference: deploy.py:190-309).  Here every process runs
the same runner; the three bring-up flags become the rendezvous of one
``torch.distributed`` process group: ``--coordinator-address HOST:PORT`` is
``init_method="tcp://HOST:PORT"``, ``--num-processes`` the world size and
``--process-id`` the rank (exported as ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK``, which the runner joins instead of spawning
ranks).  Each invocation is one rank on one device (rank i takes card i of
its host); JAX's is one host with all its devices.

Usage, one invocation per rank::

  python3 -m aggregathor_tpu_torch.cli.deploy \\
      --coordinator-address HOST0:1234 --num-processes 4 --process-id $RANK \\
      -- --experiment mnist --aggregator krum --nb-workers 32 ...

Arguments after ``--`` go to the runner unchanged.  Without the three flags
(and without ``--cluster``) the runner starts as it would alone: it joins a
group its environment names, or spawns its own ranks.

``--local-simulate K`` forks K local processes that form a K-rank gloo
group on the CPU (the runner gets ``--device cpu`` unless its arguments
name a device) on 127.0.0.1, at ``--port`` or a free port: the
single-machine deployment of the reference (README.md:141-146).

``--cluster SPEC`` resolves the three flags from the reference's
cluster-spec forms (inline JSON / file / ``G5k`` reading
``$OAR_FILE_NODES``, tools/cluster.py:48-91) through
``utils.cluster.cluster_spec``.
"""

import argparse
import os
import subprocess
import sys


def build_parser():
    parser = argparse.ArgumentParser(prog="aggregathor-torch deploy", description="Multi-process bring-up for the runner")
    parser.add_argument("--coordinator-address", default=None, help="host:port of rank 0's rendezvous")
    parser.add_argument("--num-processes", type=int, default=None, help="total rank count (the world size)")
    parser.add_argument("--process-id", type=int, default=None, help="this process' rank")
    parser.add_argument(
        "--cluster", default=None, metavar="SPEC",
        help="resolve the bring-up triple from a cluster spec instead of the three flags above: inline JSON "
             "('[\"h0\",\"h1\"]' or '{\"hosts\": [...], \"port\": N}'), a nodefile/JSON path, or 'G5k' to read "
             "$OAR_FILE_NODES -- the reference's --cluster forms (tools/cluster.py:48-91); this host's rank comes "
             "from hostname match or $AGGREGATHOR_PROCESS_ID",
    )
    parser.add_argument("--local-simulate", type=int, default=0, metavar="K",
                        help="fork K local CPU ranks forming a gloo group on localhost (single-machine parity)")
    parser.add_argument("--devices-per-process", type=int, default=1,
                        help="devices a process drives: 1 (each rank is one device in this port)")
    parser.add_argument("--port", type=int, default=None,
                        help="rendezvous port when the spec names none (default 7000, the reference's fixed port, "
                             "tools/cluster.py:60; --local-simulate: a free port)")
    parser.add_argument("runner_args", nargs=argparse.REMAINDER, help="arguments after -- go to the runner")
    return parser


def _strip_separator(rest):
    return rest[1:] if rest and rest[0] == "--" else rest


def local_simulate(nb_processes, port, runner_args):
    """Fork a K-rank localhost group on the CPU running the runner; returns
    the first non-zero exit code (0 when every rank succeeded)."""
    if "--device" not in runner_args:
        runner_args = list(runner_args) + ["--device", "cpu"]
    procs = []
    for rank in range(nb_processes):
        cmd = [sys.executable, "-m", "aggregathor_tpu_torch.cli.deploy",
               "--coordinator-address", "127.0.0.1:%d" % port, "--num-processes", str(nb_processes),
               "--process-id", str(rank), "--"] + list(runner_args)
        procs.append(subprocess.Popen(cmd))
    code = 0
    for proc in procs:
        code = proc.wait() or code
    return code


def main(argv=None):
    from ..utils import UserException

    args = build_parser().parse_args(argv)
    runner_args = _strip_separator(args.runner_args)
    if args.devices_per_process != 1:
        raise UserException("--devices-per-process: each rank of this port drives one device; start one process "
                            "a device (--num-processes) instead")
    if args.local_simulate > 0:
        from ..parallel.mesh import free_port

        return local_simulate(args.local_simulate, args.port or free_port(), runner_args)
    if args.cluster is not None:
        if args.coordinator_address is not None or args.num_processes is not None or args.process_id is not None:
            raise UserException(
                "--cluster and --coordinator-address/--num-processes/--process-id are two ways to name the same "
                "thing; pass one (a spec'd host's rank can be pinned via $AGGREGATHOR_PROCESS_ID)")
        from ..utils.cluster import cluster_spec

        args.coordinator_address, args.num_processes, args.process_id = cluster_spec(args.cluster, port=args.port)
    if args.coordinator_address is not None:
        if args.num_processes is None or args.process_id is None:
            raise UserException("--coordinator-address needs --num-processes and --process-id")
        host, _, port = args.coordinator_address.rpartition(":")
        if not host:
            host, port = args.coordinator_address, str(args.port or 7000)
        os.environ.update({"MASTER_ADDR": host, "MASTER_PORT": port, "WORLD_SIZE": str(args.num_processes),
                           "RANK": str(args.process_id)})

    from . import runner

    runner.main(runner_args)
    return 0


def cli():
    """Console entry: UserException -> clean error + exit code 1."""
    from ..utils import UserException, error

    try:
        return main()
    except UserException as exc:
        error(str(exc))
        return 1


if __name__ == "__main__":
    sys.exit(cli())
