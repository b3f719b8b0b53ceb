"""The one traffic generator: a mix file's parameters (flowbench/traffic/
<mix>.json) and a cell's world as plain data -> the batch of every step,
the same for the program and for the reference.

Traffic is connections.  Each step opens `new_per_step` of them (their
first packets lead the batch) and fills the rest of its `batch` lanes with
later packets of the connections opened in the `life_steps` steps before,
drawn afresh each step (a uniform age, then a uniform connection of that
age).  A later packet of a connection whose class `replies` travels in the
reply direction with probability `reply_share`; other classes' later
packets are their first packet's retransmissions.

A connection's class is drawn by `share` from `classes`, each of a `kind`:

- policy_in: a Pod that one of a local Pod's ingress Allow rules admits,
  to that local Pod, on the rule's port (a rule of every port: a port of
  `ports`);
- local_out: a local Pod to a Pod of another node, on a port of `ports`;
- external_in / external_out: an address outside the cluster (11.0.0.0 to
  126.255.255.255) to a local Pod / from one, on a port of `ports`; with
  `sources`, the outside addresses are that many.

Client ports are uniform in 1024-65535.  Everything is drawn before the
window: `templates` batches, step t takes template t % templates with
every client port rotated by a prime per pass over the templates, so no
connection repeats.  A lane's ingress port is its source's: a local Pod's
ofport, the tunnel for another node's Pod, the gateway for the outside.
Step t runs at now = now_start + now_step * t."""

from __future__ import annotations

import numpy as np

from .world import sub_seed

KINDS = ("policy_in", "local_out", "external_in", "external_out")
_ROTATE = 20011
_PORTS = 64512          # client ports 1024..65535
_EXT = (0x0B000000, 0x7F000000)
OFPORT_TUNNEL, OFPORT_GATEWAY = 1, 2


def _u32(ip: str) -> int:
    a, b, c, d = (int(x) for x in ip.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


def _admitted(policy: dict, local: np.ndarray):
    """Every (local Pod, admitted peers, ports) of the ingress Allow rules
    whose peers are address groups -> (locals, peer offsets, peer counts,
    peers, port offsets, port counts, ports [[proto, port]])."""
    is_local = set(local.tolist())
    sigs = {}
    for p in policy["policies"]:
        for r in p["rules"]:
            peer = r["peer"]
            if (r["direction"] != "In" or r["action"] != "Allow"
                    or peer["blocks"] or not peer["groups"]):
                continue
            ports = tuple((s["proto"], s["port"]) for s in r["services"]
                          if s["port"] is not None and s["end_port"] is None)
            if len(ports) != len(r["services"]):
                continue
            sigs[(tuple(r["applied_to"] or p["applied_to"]),
                  tuple(peer["groups"]), ports)] = None
    locs, peers, pcount, ports, qcount = [], [], [], [], []
    for atgs, groups, pt in sigs:
        mem = {_u32(ip) for g in atgs
               for ip in policy["applied_to_groups"].get(g, [])}
        adm = sorted({_u32(ip) for g in groups
                      for ip in policy["address_groups"][g]["ips"]})
        if not adm:
            continue
        for m in sorted(mem & is_local):
            locs.append(m)
            peers.append(adm)
            pcount.append(len(adm))
            ports.append(pt)
            qcount.append(len(pt))
    if not locs:
        return None
    off = np.concatenate([[0], np.cumsum(pcount)[:-1]])
    qoff = np.concatenate([[0], np.cumsum(qcount)[:-1]])
    flat = [q for pt in ports for q in pt]
    return (np.asarray(locs, np.int64), off, np.asarray(pcount),
            np.concatenate([np.asarray(a, np.int64) for a in peers]),
            qoff, np.asarray(qcount),
            np.asarray(flat, np.int64).reshape(-1, 2))


class Stream:
    def __init__(self, mix: dict, plain: dict, seed: int):
        self.batch_size = b = int(mix["batch"])
        self.new = n = int(mix["new_per_step"])
        self.life = life = int(mix["life_steps"])
        self.period = R = int(mix["templates"])
        self.now_start = int(mix["now_start"])
        self.now_step = int(mix["now_step"])
        self.warm_steps = int(mix["warm_steps"])
        if not (0 < n <= b and 0 < life < R):
            raise ValueError("need 0 < new_per_step <= batch and "
                             "0 < life_steps < templates")
        rng = np.random.default_rng(sub_seed(seed, "traffic"))
        c = self._connections(mix, plain, rng, R * n)
        lp = sorted((_u32(ip), p) for ip, p in plain["topology"]["local_pods"])
        ports = (np.asarray([a for a, _ in lp], np.int64),
                 np.asarray([p for _, p in lp], np.int64))
        pods = np.sort(np.asarray(plain["pod_ips"], np.int64))
        c["cin"] = self._in_port(c["client"], ports, pods)
        c["sin"] = self._in_port(c["server"], ports, pods)
        self.templates = []
        share = float(mix["reply_share"])
        for r in range(R):
            age = rng.integers(1, life + 1, b - n)
            blk = r - age
            conn = np.concatenate([np.arange(r * n, (r + 1) * n),
                                   (blk % R) * n + rng.integers(0, n, b - n)])
            rep = np.concatenate([np.zeros(n, bool),
                                  c["replies"][conn[n:]]
                                  & (rng.random(b - n) < share)])

            def pick(fwd, back):
                return np.where(rep, c[back][conn], c[fwd][conn])
            self.templates.append(dict(
                src_ip=pick("client", "server"),
                dst_ip=pick("server", "client"),
                proto=c["proto"][conn], fixed=c["server_port"][conn],
                base=(c["client_port"][conn] - 1024).astype(np.uint32),
                reply=rep.astype(np.int32),
                off=np.concatenate([np.zeros(n, np.uint32),
                                    (blk < 0).astype(np.uint32)]),
                in_port=pick("cin", "sin")))

    @staticmethod
    def _in_port(src, ports: tuple, pods: np.ndarray) -> np.ndarray:
        lk, lp = ports
        i = np.minimum(np.searchsorted(lk, src), len(lk) - 1)
        j = np.minimum(np.searchsorted(pods, src), len(pods) - 1)
        src = src.astype(np.int64)
        return np.where(lk[i] == src, lp[i], np.where(
            pods[j] == src, OFPORT_TUNNEL, OFPORT_GATEWAY)).astype(np.int32)

    @staticmethod
    def _connections(mix: dict, plain: dict, rng, m: int) -> dict:
        classes = mix["classes"]
        w = np.asarray([k["share"] for k in classes], float)
        cls = rng.choice(len(classes), size=m, p=w / w.sum())
        local = np.asarray(plain["local_ips"], np.int64)
        others = np.setdiff1d(np.asarray(plain["pod_ips"], np.int64), local)
        mport = np.asarray(mix["ports"], np.int64).reshape(-1, 2)
        out = {k: np.zeros(m, np.uint32 if k in ("client", "server")
                           else np.int32)
               for k in ("client", "server", "proto", "server_port",
                         "client_port")}
        out["replies"] = np.zeros(m, bool)
        adm = None
        for i, k in enumerate(classes):
            sel = np.nonzero(cls == i)[0]
            q = len(sel)
            if not q:
                continue
            kind = k["kind"]
            if kind not in KINDS:
                raise ValueError(f"unknown traffic kind {kind!r}")
            pt = mport[rng.integers(0, len(mport), q)]
            if kind == "policy_in":
                if adm is None:
                    adm = _admitted(plain["policy"], local)
                if adm is None:
                    raise ValueError("policy_in: no local Pod is admitted "
                                     "by an address-group Allow rule")
                locs, poff, pcnt, peers, qoff, qcnt, qports = adm
                e = rng.integers(0, len(locs), q)
                client = peers[poff[e] + (rng.random(q) * pcnt[e]).astype(
                    np.int64)]
                server = locs[e]
                own = qcnt[e] > 0
                j = qoff[e] + (rng.random(q) * np.maximum(qcnt[e], 1)).astype(
                    np.int64)
                pt = np.where(own[:, None],
                              qports[np.minimum(j, len(qports) - 1)]
                              if len(qports) else pt, pt)
            else:
                ext = rng.integers(*_EXT, q)
                if "sources" in k:
                    ext = rng.integers(*_EXT, int(k["sources"]))[
                        rng.integers(0, int(k["sources"]), q)]
                lo = local[rng.integers(0, len(local), q)]
                if kind == "local_out":
                    client, server = lo, others[rng.integers(0, len(others),
                                                             q)]
                elif kind == "external_in":
                    client, server = ext, lo
                else:
                    client, server = lo, ext
            out["client"][sel], out["server"][sel] = client, server
            out["proto"][sel], out["server_port"][sel] = pt[:, 0], pt[:, 1]
            out["client_port"][sel] = rng.integers(1024, 65536, q)
            out["replies"][sel] = bool(k["replies"])
        return out

    def now(self, t: int) -> int:
        return self.now_start + self.now_step * t

    def columns(self, t: int) -> dict:
        """Step t's columns (src_ip, dst_ip, proto, src_port, dst_port,
        in_port) as numpy arrays; the ports are new, the rest the
        template's own (read only)."""
        T = self.templates[t % self.period]
        w = t // self.period
        r0, r1 = (w * _ROTATE) % _PORTS, ((w - 1) * _ROTATE) % _PORTS
        # Client ports (base + rotation) mod _PORTS, by arithmetic alone:
        # masks of random bits make np.where slow.
        s = T["base"] + np.uint32(r0) + np.uint32((r1 - r0) % 2**32) * T["off"]
        s = np.minimum(s, s - np.uint32(_PORTS)).view(np.int32) + 1024
        d = T["reply"] * (T["fixed"] - s)
        return {"src_ip": T["src_ip"], "dst_ip": T["dst_ip"],
                "proto": T["proto"], "src_port": s + d,
                "dst_port": T["fixed"] - d, "in_port": T["in_port"]}

    def batch(self, t: int):
        """Step t's PacketBatch, the program's input."""
        from antrea_tpu_torch.packet import PacketBatch

        return PacketBatch(**self.columns(t))
