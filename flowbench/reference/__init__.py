"""The plain reference of the node agent's engine, which decides `correct`.

Plain PyTorch (any device) and the standard library.  It imports nothing of
the program and takes nothing the program made: from the cell's generated
inputs as plain data (flowbench/world.plain_world) it works out the policy
order and membership, the Service frontends and endpoints, and node-0's
forwarding itself, and replays the run's every step from an empty flow
cache and affinity table (datapath.Replay): the verdict and its deciding
rules, the Service LB with ClientIP affinity, conntrack (est, reply,
committed), and the forwarding walk's output.

Each semantic is written from the datapath's stated behaviour, not from
the program's code: first-match policy order over tiers, then K8s
isolation, then the baseline tier; FNV-1a flow hashing into a direct-mapped
flow cache and affinity table; a batch arriving at once (lookups see the
state before it; on a slot collision the last lane in batch order wins,
the forward entry before the reply entry of the same lane)."""
