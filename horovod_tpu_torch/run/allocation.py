"""Host parsing and slot allocation: the port of
``horovod_tpu/run/allocation.py``. Given a host spec, one slot per
process with rank, local_rank, local_size, cross_rank and cross_size,
rank-major by host order.
"""

import dataclasses
import re


@dataclasses.dataclass
class HostSlots:
    hostname: str
    slots: int


@dataclasses.dataclass
class Slot:
    rank: int
    hostname: str
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    size: int


def parse_hosts(hosts_str):
    """Parse ``"host1:4,host2:2"``; a bare hostname means 1 slot."""
    out = []
    for part in hosts_str.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            out.append(HostSlots(name, int(slots)))
        else:
            out.append(HostSlots(part, 1))
    return out


def parse_hostfile(path):
    """Hostfile lines: ``hostname slots=N`` (mpirun's form); ``#`` starts
    a comment."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            m = re.match(r"^(\S+)(?:\s+slots\s*=\s*(\d+))?$", line)
            if not m:
                raise ValueError(f"bad hostfile line: {line!r}")
            out.append(HostSlots(m.group(1), int(m.group(2) or 1)))
    return out


def allocate(hosts, np):
    """Assign ``np`` ranks to the hosts' slots, host-major. For a given
    local_rank, cross_size is the number of hosts that have that
    local_rank filled and cross_rank this host's index among them."""
    total = sum(h.slots for h in hosts)
    if np > total:
        raise ValueError(
            f"requested {np} processes but hosts provide only {total} slots")
    slots = []
    rank = 0
    per_host = []  # (hostname, ranks on the host)
    for h in hosts:
        n = min(h.slots, np - rank)
        if n <= 0:
            break
        per_host.append((h.hostname, list(range(rank, rank + n))))
        rank += n
    for host_idx, (hostname, ranks) in enumerate(per_host):
        for lr, r in enumerate(ranks):
            hosts_with_lr = [i for i, (_, rr) in enumerate(per_host)
                             if lr < len(rr)]
            slots.append(Slot(
                rank=r, hostname=hostname, local_rank=lr,
                local_size=len(ranks),
                cross_rank=hosts_with_lr.index(host_idx),
                cross_size=len(hosts_with_lr), size=np))
    slots.sort(key=lambda s: s.rank)
    return slots
