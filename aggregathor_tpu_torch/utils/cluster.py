"""Cluster-spec resolution for multi-host bring-up.

The reference's ``tools/cluster.py`` (:48-91) turns a ``--cluster`` argument
— inline JSON, a JSON file, or the special ``'G5k'`` keyword that reads
Grid'5000's ``$OAR_FILE_NODES`` nodefile — into the TF ClusterSpec
(``{"ps": [first:7000], "workers": [rest:7000]}``) its deployer wires up.

A copy of ``aggregathor_tpu/utils/cluster.py``.  What a deployment needs
from the same inputs is the rendezvous triple *(coordinator_address,
num_processes, process_id)*, which ``cli/deploy.py`` turns into
``torch.distributed.init_process_group``'s ``init_method="tcp://<address>"``,
world size and rank.  This module maps each reference input form to that
triple:

- inline JSON — ``'["a","b"]'`` or ``'{"hosts": ["a","b"], "port": 7000}'``
  (the reference's explicit-spec form, tools/cluster.py:81-87);
- a path to a file holding that JSON, or a plain nodefile (one host per
  line, duplicates collapsed — the OAR file format);
- ``'G5k'`` — read the nodefile named by ``$OAR_FILE_NODES``
  (tools/cluster.py:48-68), coordinator = first host, like the reference
  electing it the PS.

``process_id`` is resolved by matching the local hostname against the host
list (OAR gives no rank env), overridable via ``$AGGREGATHOR_PROCESS_ID``
for launchers that do export a rank.
"""

import json
import os
import socket

from . import UserException

DEFAULT_PORT = 7000  # the reference's fixed port (tools/cluster.py:60)


def parse_nodefile(path):
    """Unique hostnames in first-seen order (OAR repeats one line per core)."""
    try:
        with open(path) as fd:
            lines = [line.strip() for line in fd]
    except OSError as exc:
        raise UserException("Cannot read nodefile %r: %s" % (path, exc))
    hosts = []
    for line in lines:
        if line and line not in hosts:
            hosts.append(line)
    if not hosts:
        raise UserException("Nodefile %r lists no hosts" % (path,))
    return hosts


def _hosts_from_json(value):
    """Accept ``["a", "b"]`` or ``{"hosts": [...], "port": N}``."""
    port = None
    if isinstance(value, dict):
        port = value.get("port")
        if port is not None and not isinstance(port, int):
            raise UserException(
                'Cluster JSON "port" must be an integer (got %r)' % (port,)
            )
        value = value.get("hosts")
    if not isinstance(value, (list, tuple)) or not value or not all(
        isinstance(h, str) and h for h in value
    ):
        raise UserException(
            "Cluster JSON must be a non-empty host list or "
            '{"hosts": [...], "port": N}'
        )
    return list(value), port


def _local_names():
    names = {socket.gethostname()}
    try:
        names.add(socket.getfqdn())
    except OSError:
        pass
    names.update({n.split(".")[0] for n in tuple(names)})
    return names


def resolve_process_id(hosts):
    """This host's rank: $AGGREGATHOR_PROCESS_ID, else hostname match."""
    override = os.environ.get("AGGREGATHOR_PROCESS_ID")
    if override is not None:
        try:
            rank = int(override)
        except ValueError:
            raise UserException(
                "AGGREGATHOR_PROCESS_ID=%r is not an integer rank" % (override,)
            )
        if not 0 <= rank < len(hosts):
            raise UserException(
                "AGGREGATHOR_PROCESS_ID=%d out of range for %d hosts" % (rank, len(hosts))
            )
        return rank
    local = _local_names()
    for rank, host in enumerate(hosts):
        bare = host.split(":")[0]
        if bare in local or bare.split(".")[0] in {n.split(".")[0] for n in local}:
            return rank
    raise UserException(
        "Cannot resolve this host's rank: %s matches none of %s; set "
        "AGGREGATHOR_PROCESS_ID" % (sorted(local), hosts)
    )


def cluster_spec(argument, port=None):
    """``--cluster`` argument -> (coordinator_address, num_processes, process_id).

    Reference parity: the same three input forms as ``cluster_parse``
    (tools/cluster.py:81-91), mapped to the SPMD bring-up triple instead of
    a ps/workers ClusterSpec."""
    spec_port = None
    if argument.strip() == "G5k":  # the reference's special parser keyword
        nodefile = os.environ.get("OAR_FILE_NODES")
        if not nodefile:
            raise UserException(
                "--cluster G5k needs $OAR_FILE_NODES (run inside an OAR job, "
                "tools/cluster.py:48-68)"
            )
        hosts = parse_nodefile(nodefile)
    else:
        stripped = argument.strip()
        if stripped[:1] in ("[", "{"):
            try:
                value = json.loads(stripped)
            except ValueError as exc:
                raise UserException("Invalid cluster JSON: %s" % (exc,))
            hosts, spec_port = _hosts_from_json(value)
        elif os.path.exists(stripped):
            try:
                with open(stripped) as fd:
                    content = fd.read()
            except OSError as exc:
                raise UserException("Cannot read cluster spec %r: %s" % (stripped, exc))
            if content[:1] in ("[", "{"):
                try:
                    value = json.loads(content)
                except ValueError as exc:
                    raise UserException(
                        "Invalid cluster JSON in %r: %s" % (stripped, exc)
                    )
                hosts, spec_port = _hosts_from_json(value)
            else:
                hosts = parse_nodefile(stripped)
        else:
            raise UserException(
                "--cluster must be 'G5k', inline JSON, or a readable "
                "nodefile/JSON path (got %r)" % (argument,)
            )
    use_port = port if port is not None else (spec_port if spec_port else DEFAULT_PORT)
    coordinator = hosts[0]
    if ":" not in coordinator:
        coordinator = "%s:%d" % (coordinator, use_port)
    return coordinator, len(hosts), resolve_process_id(hosts)
