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
  `sources`, the outside addresses are that many;
- service: a local Pod to a ClusterIP frontend of the world's Services
  (`plain["services"]`), on the frontend's own protocol and port (the
  kind draws nothing from `ports`).  `popularity` 0 draws the frontends
  uniformly; s > 0 by Zipf rank-s over a seeded permutation of the
  Services.  A remote client's Service traffic reaches this node already
  load-balanced by its own node, which is policy_in's shape.

Client ports are uniform in 1024-65535.  Everything is drawn before the
window: `templates` batches, step t takes template t % templates with
every client port rotated by a prime per pass over the templates, so no
connection repeats.  A lane's ingress port is its source's: a local Pod's
ofport, the tunnel for another node's Pod, the gateway for the outside.
Step t runs at now = now_start + now_step * t.

Replies of Service connections close the loop.  The endpoint that answers
is the one the datapath chose for the connection's first packet: (flow
hash & 0x7FFFFFFF) mod the endpoint count, or, under ClientIP affinity,
the client's pin in the direct-mapped affinity table at that moment,
which depends on every earlier miss; only the datapath knows it.  So
observe(t, result) keeps, for step t's Service first packets, the
reported code, dnat_ip and dnat_port (nothing else of the result), and a
later Service packet drawn as a reply is the endpoint's packet (dnat_ip:
dnat_port to the client, entering at the endpoint's port), where the
first packet was an allowed DNAT.  Otherwise (a Service without
endpoints rejects, policy denies, or the connection opened before step
0 and its first packet was never sent) it is the client's forward packet
again.  columns(t) builds every step from these records, so a replay of
the run after it sees the very lanes the program saw.

The check stays independent of what the program reports: a program that
picks another endpoint than the reference fails `lanes_off` on the first
packets of the checked steps; its replies then come from an endpoint the
reference never committed, so the reference misses where the program hits
and `steps_miss_count_off` fails on every step that carries them; and one
that reports one endpoint and caches another fails `lanes_off` on the
first packets.  A mix without a service class observes nothing, and its
columns(t) are the templates' arrays as before."""

from __future__ import annotations

import numpy as np

from .world import sub_seed

KINDS = ("policy_in", "local_out", "external_in", "external_out",
         "service")
ALLOW = 0
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


def _service(k: dict, plain: dict, local: np.ndarray, rng, q: int):
    """q Service connections: clients uniform over the local Pods,
    frontends uniform (popularity 0) or Zipf rank-s over a seeded
    permutation of the Services -> (clients, frontend IPs, [[proto,
    port]])."""
    svcs = plain["services"]
    if not svcs:
        raise ValueError("service: the world has no Services")
    front = np.asarray([[_u32(v["ip"]), v["proto"], v["port"]]
                        for v in svcs], np.int64)
    s = float(k.get("popularity", 0))
    if s < 0:
        raise ValueError("service: popularity must be 0 or more")
    client = local[rng.integers(0, len(local), q)]
    if s == 0:
        f = rng.integers(0, len(svcs), q)
    else:
        p = np.arange(1, len(svcs) + 1, dtype=float) ** -s
        f = rng.permutation(len(svcs))[rng.choice(len(svcs), q, p=p / p.sum())]
    return client, front[f, 0], front[f, 1:]


# One observed Service first packet as a u64: its endpoint's address
# (bits 32-63) and port (16-31), and the port its replies enter at (0-15),
# where it was an allowed DNAT; 0 where not.
_IP, _PORT, _IN = 32, 16, 0xFFFF


class _InPorts:
    """An address -> the port its packets enter at: a local Pod's ofport,
    the tunnel for another node's Pod, the gateway for the outside.  A
    table over the span of the Pods' addresses (at most a /8's)."""

    def __init__(self, plain: dict):
        lp = np.asarray([[_u32(ip), p] for ip, p in
                         plain["topology"]["local_pods"]], np.int64)
        pods = np.asarray(plain["pod_ips"], np.int64)
        self.lo = int(min(pods.min(), lp[:, 0].min()))
        span = int(max(pods.max(), lp[:, 0].max())) - self.lo + 1
        if span > 1 << 24 or lp[:, 1].max() > 0xFFFF:
            raise ValueError("Pods beyond a /8, or an ofport beyond 16 bits")
        self.tab = np.full(span, OFPORT_GATEWAY, np.uint16)
        self.tab[pods - self.lo] = OFPORT_TUNNEL
        self.tab[lp[:, 0] - self.lo] = lp[:, 1]

    def __call__(self, ip) -> np.ndarray:
        k = np.asarray(ip, np.int64) - self.lo
        inside = (k >= 0) & (k < len(self.tab))
        return np.where(inside, self.tab[np.where(inside, k, 0)],
                        OFPORT_GATEWAY).astype(np.int32)


def _col(result, name: str) -> np.ndarray:
    """A column of a StepResult or of a dict of columns."""
    v = result[name] if isinstance(result, dict) else getattr(result, name)
    return np.asarray(v)


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
        self._in_port = _InPorts(plain)
        c["cin"] = self._in_port(c["client"])
        c["sin"] = self._in_port(c["server"])
        self.services = any(k["kind"] == "service" for k in mix["classes"])
        # A Service connection's rank among its step's Service connections.
        rank = (np.cumsum(c["svc"].reshape(R, n), axis=1) - 1).reshape(-1)
        self._obs = []
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
            # A Service reply is the client's forward packet in the
            # template; columns(t) turns it round where observe() saw the
            # endpoint.  The later lanes are drawn alike, so their order
            # is free: Service replies go last, by age, to be turned
            # round in slices.
            svc_rep = rep & c["svc"][conn]
            if self.services:
                o = np.lexsort((age, svc_rep[n:]))
                age, blk = age[o], blk[o]
                conn[n:], rep[n:], svc_rep[n:] = (conn[n:][o], rep[n:][o],
                                                  svc_rep[n:][o])
            rep &= ~svc_rep

            def pick(fwd, back):
                return np.where(rep, c[back][conn], c[fwd][conn])
            T = dict(
                src_ip=pick("client", "server"),
                dst_ip=pick("server", "client"),
                proto=c["proto"][conn], fixed=c["server_port"][conn],
                base=(c["client_port"][conn] - 1024).astype(np.uint32),
                reply=rep.astype(np.int32),
                off=np.concatenate([np.zeros(n, np.uint32),
                                    (blk < 0).astype(np.uint32)]),
                in_port=pick("cin", "sin"))
            if self.services:
                first = np.nonzero(c["svc"][r * n:(r + 1) * n])[0]
                T["svc_first"] = first
                T["svc_front"] = (c["server"][r * n + first].astype(np.int64),
                                  c["server_port"][r * n + first])
                # The replies, lanes svc_from on: each one's connection's
                # rank among its step's Service ones, and the slice of
                # them of each age.
                lo = b - int(svc_rep.sum())
                a = age[lo - n:]
                T["svc_from"], T["svc_rank"] = lo, rank[conn[lo:]]
                T["svc_ages"] = [(int(g), slice(*np.searchsorted(a, [g, g + 1])))
                                 for g in np.unique(a)]
            self.templates.append(T)

    @staticmethod
    def _connections(mix: dict, plain: dict, rng, m: int) -> dict:
        classes = mix["classes"]
        w = np.asarray([k["share"] for k in classes], float)
        cls = rng.choice(len(classes), size=m, p=w / w.sum())
        local = np.asarray(plain["local_ips"], np.int64)
        others = np.setdiff1d(np.asarray(plain["pod_ips"], np.int64), local)
        mport = np.asarray(mix.get("ports", []), np.int64).reshape(-1, 2)
        out = {k: np.zeros(m, np.uint32 if k in ("client", "server")
                           else np.int32)
               for k in ("client", "server", "proto", "server_port",
                         "client_port")}
        out["replies"] = np.zeros(m, bool)
        out["svc"] = np.zeros(m, bool)
        adm = None
        for i, k in enumerate(classes):
            sel = np.nonzero(cls == i)[0]
            q = len(sel)
            if not q:
                continue
            kind = k["kind"]
            if kind not in KINDS:
                raise ValueError(f"unknown traffic kind {kind!r}")
            if kind == "service":
                client, server, pt = _service(k, plain, local, rng, q)
                out["svc"][sel] = True
            else:
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
            elif kind != "service":
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

    def observe(self, t: int, result) -> None:
        """Keep step t's Service first packets' reported code, dnat_ip and
        dnat_port (a StepResult, or a dict of columns such as the
        reference's): the endpoint of each allowed DNAT, and the port its
        replies enter at.  Steps are observed in order, each once."""
        if not self.services:
            return
        if t != len(self._obs):
            raise ValueError(f"observe({t}) after {len(self._obs)} steps")
        T = self.templates[t % self.period]
        j = T["svc_first"]
        ip = _col(result, "dnat_ip")[j].astype(np.int64) & 0xFFFFFFFF
        port = _col(result, "dnat_port")[j].astype(np.int64)
        vip, vport = T["svc_front"]
        ok = (_col(result, "code")[j] == ALLOW) & ((ip != vip)
                                                   | (port != vport))
        rec = np.zeros(len(j), np.uint64)
        ip, port = ip[ok], port[ok]
        u = np.uint64
        rec[ok] = ((ip.astype(u) << _IP) | (port.astype(u) << _PORT)
                   | self._in_port(ip).astype(u))
        self._obs.append(rec)

    def columns(self, t: int) -> dict:
        """Step t's columns (src_ip, dst_ip, proto, src_port, dst_port,
        in_port) as numpy arrays; the ports are new, the rest the
        template's own (read only), but for a Service mix's replies, which
        need observe() of the steps before t."""
        T = self.templates[t % self.period]
        w = t // self.period
        r0, r1 = (w * _ROTATE) % _PORTS, ((w - 1) * _ROTATE) % _PORTS
        # Client ports (base + rotation) mod _PORTS, by arithmetic alone:
        # masks of random bits make np.where slow.
        s = T["base"] + np.uint32(r0) + np.uint32((r1 - r0) % 2**32) * T["off"]
        s = np.minimum(s, s - np.uint32(_PORTS)).view(np.int32) + 1024
        d = T["reply"] * (T["fixed"] - s)
        out = {"src_ip": T["src_ip"], "dst_ip": T["dst_ip"],
               "proto": T["proto"], "src_port": s + d,
               "dst_port": T["fixed"] - d, "in_port": T["in_port"]}
        if self.services:
            self._replies(t, T, out)
        return out

    def _replies(self, t: int, T: dict, out: dict) -> None:
        """Turn step t's Service replies round, each to come from the
        endpoint its connection's first packet was sent to."""
        if t - 1 >= len(self._obs):
            raise ValueError(f"columns({t}) of a Service mix needs "
                             f"observe() of steps 0-{t - 1}")
        lo = T["svc_from"]
        rec = np.zeros(len(T["svc_rank"]), np.uint64)
        for age, sl in T["svc_ages"]:
            if t >= age:
                rec[sl] = self._obs[t - age][T["svc_rank"][sl]]
        ok = rec != 0
        src, dst, inp = (out[k].copy() for k in ("src_ip", "dst_ip",
                                                 "in_port"))
        sp, dp = out["src_port"], out["dst_port"]
        client, cport = src[lo:].copy(), sp[lo:].copy()
        src[lo:] = np.where(ok, (rec >> _IP).astype(np.uint32), client)
        sp[lo:] = np.where(ok, ((rec >> _PORT) & 0xFFFF).astype(np.int32),
                           cport)
        inp[lo:] = np.where(ok, (rec & _IN).astype(np.int32), inp[lo:])
        dst[lo:] = np.where(ok, client, dst[lo:])
        dp[lo:] = np.where(ok, cport, dp[lo:])
        out.update(src_ip=src, dst_ip=dst, in_port=inp)

    def batch(self, t: int):
        """Step t's PacketBatch, the program's input."""
        from antrea_tpu_torch.packet import PacketBatch

        return PacketBatch(**self.columns(t))
