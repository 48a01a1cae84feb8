"""What decides `correct`: the plain reference follows the program step
by step from the program's own recorded state (the physics is chaotic:
a free-running reference parts from the kernel within a few dozen steps
at the last bit), and judges what the program produced.

- Every control step is an answer per env: the action (and in training
  its log-prob and the value), the next state, the step's outputs and
  the records. An env-step is wrong when a discrete field differs or a
  float field's gap exceeds its tolerance (`tolerances` in the cell's
  limits file). `answers_wrong` is the share of wrong env-steps.
- Training: the batch's observations, actions and rewards must be
  those of the recorded steps, row by row; the reference recomputes its
  returns and advantages (GAE, the normalization) from the program's
  step outputs and values; and it runs
  the PPO update from the program's parameters and Adam state at the
  iteration's start, with the same permutations. It compares each
  iteration's loss, the first moment of Adam after the first iteration
  (the gradients as the optimizer got them), and the parameters' change
  over the check iterations, per leaf.
The start is checked by itself: the reference resets from the same draws
and its state must equal the program's."""

from __future__ import annotations

import statistics

import torch

from benchmark.harness import tree
from benchmark.reference import drivers as ref_drivers
from benchmark.reference import ppo as ref_ppo


class Tally:
    """Wrong env-steps, in all and by field, and the largest gap of each
    field group (|gap| / (1 + |reference|)) seen."""

    def __init__(self):
        self.total, self.wrong, self.by_field, self.max_gap = 0, 0, {}, {}

    def gap(self, group: str, prog: torch.Tensor, ref: torch.Tensor) -> None:
        if ref.dtype.is_floating_point:
            g = ((prog.to(ref.device) - ref).abs() / (1.0 + ref.abs())).nan_to_num(0.0)
            self.max_gap[group] = max(self.max_gap.get(group, 0.0), float(g.max()))

    def add(self, flags: dict, rows: int) -> None:
        """`flags`: field -> (rows,) bool, True where that field is wrong."""
        any_wrong = torch.zeros(rows, dtype=torch.bool, device=next(iter(flags.values())).device)
        for name, f in flags.items():
            any_wrong |= f
            self.by_field[name] = self.by_field.get(name, 0) + int(f.sum())
        self.total += rows
        self.wrong += int(any_wrong.sum())

    @property
    def share(self) -> float:
        return self.wrong / max(self.total, 1)


def _rows_wrong(prog: torch.Tensor, ref: torch.Tensor, tol_abs: float, tol_rel: float):
    """(rows,) bool: some element of the row is not within tolerance
    (exactly equal for bool and integer fields; non-finite equals
    non-finite)."""
    prog = prog.to(ref.device).reshape(ref.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    if not ref.dtype.is_floating_point:
        return (prog != ref).any(dim=1)
    ok = (prog - ref).abs() <= tol_abs + tol_rel * ref.abs()
    ok |= (prog == ref) | (~torch.isfinite(prog) & ~torch.isfinite(ref))
    return ~ok.all(dim=1)


def compare_trees(prog, ref, names: tuple, tol_abs: float, tol_rel: float, prefix: str) -> dict:
    """Field -> (rows,) wrong flags for two trees of one type."""
    out = {}
    for name, p, r in zip(names, tree.leaves(prog), tree.leaves(ref)):
        out[f"{prefix}{name}"] = _rows_wrong(p, r, tol_abs, tol_rel)
    return out


def field_names(x, prefix="") -> tuple:
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return tuple(n for f, v in zip(x._fields, x) for n in field_names(v, f"{prefix}{f}."))
    return (prefix[:-1],)


def follow(env, policy, steps: list, obs0, draws: list, tol: dict, tally: Tally, block: int,
           noise=None, prog_policy=None, records=None, device=None) -> ref_drivers.PolicyOut:
    """Step the reference through the program's recorded `steps`
    ((state, action, out, next state) per control step, in the
    reference's types, on any device), `block` steps at a time stacked
    over the env axis, and tally each env-step's answers. `obs0` is the
    observation the first step acted on; `noise` (T, N, A) the action
    noise (None: the mean action); `prog_policy` the program's (T, N, 1)
    log-probs and values, where it returns them; `records` its (T, N)
    host records. Returns the reference's policy outputs (T, N, .) and
    the step outputs it computed, for the batch."""
    T = len(steps)
    obs_in = [obs0] + [s[2].obs for s in steps[:-1]]
    pol_rows, out_rows = [], []
    for b in range(0, T, block):
        ts = range(b, min(T, b + block))
        N = obs_in[b].shape[0]
        state = tree.to(tree.cat([steps[t][0] for t in ts]), device, tree.reference_types())
        # the policy at the program's shapes, a step at a time
        pol = ref_drivers.PolicyOut(*(torch.cat(x) for x in zip(*(
            ref_drivers.act(policy, obs_in[t].to(device),
                            None if noise is None else noise[t].to(device)) for t in ts))))
        nxt, out = env.step(state, pol.action, draws=tree.cat([draws[t] for t in ts]))
        rows = len(ts) * N
        prog_action = torch.cat([steps[t][1] for t in ts])
        flags = {"action": _rows_wrong(prog_action, pol.action, tol["policy"], tol["policy"])}
        tally.gap("policy", prog_action, pol.action)
        if prog_policy is not None:
            lp, val = (x[b:b + len(ts)].reshape(rows, -1) for x in prog_policy)
            flags["log_prob"] = _rows_wrong(lp, pol.log_prob, tol["policy"], tol["policy"])
            flags["value"] = _rows_wrong(val, pol.value, tol["policy"], tol["policy"])
            tally.gap("policy", lp, pol.log_prob)
            tally.gap("policy", val, pol.value)
        prog_out = tree.cat([steps[t][2] for t in ts])
        prog_next = tree.cat([steps[t][3] for t in ts])
        flags.update(compare_trees(prog_out, out, field_names(out), tol["env_abs"],
                                   tol["env_rel"], "out."))
        tally.gap("env", prog_out.obs, out.obs)
        tally.gap("env", prog_next.phys.qd, nxt.phys.qd)
        flags.update(compare_trees(prog_next, nxt, field_names(nxt), tol["env_abs"],
                                   tol["env_rel"], "state."))
        if records is not None:
            ref_rec = {"reward": out.reward, "hit": out.hit, "done": out.done,
                       "timeout": out.timeout, "ep_return": out.ep_return, "ep_len": out.ep_len,
                       "ns_pre": state.next_step_index}
            for name, ref_x in ref_rec.items():
                prog_x = torch.as_tensor(records[name][b:b + len(ts)]).reshape(-1)
                flags[f"records.{name}"] = _rows_wrong(prog_x.to(ref_x.dtype), ref_x,
                                                       tol["env_abs"], tol["env_rel"])
        tally.add(flags, rows)
        split = lambda x: x.reshape(len(ts), N, *x.shape[1:])
        pol_rows.append(ref_drivers.PolicyOut(*(split(x) for x in pol)))
        out_rows.append(tuple(split(x) for x in (out.reward, out.done, out.timeout)))
    policy_out = ref_drivers.PolicyOut(*(torch.cat(x) for x in zip(*pol_rows)))
    reward, done, timeout = (torch.cat(x) for x in zip(*out_rows))
    return policy_out, reward, done, timeout


def check_start(prog_state, prog_obs, ref_state, ref_obs, tally: Tally, tol: dict) -> None:
    flags = compare_trees(prog_state, ref_state, field_names(ref_state), tol["env_abs"],
                          tol["env_rel"], "reset.")
    flags["reset.obs"] = _rows_wrong(prog_obs, ref_obs, tol["env_abs"], tol["env_rel"])
    tally.add(flags, ref_obs.shape[0])


def check_batch(policy, prog: dict, steps: list, obs0, obs_last, config: dict, tol: dict,
                tally: Tally) -> None:
    """The batch stage by itself, row by row: its observations, actions and
    rewards must equal what the recorded steps were fed and returned
    (`obs0` the observation the first step acted on); GAE with time-limit
    bootstrapping and the advantages' normalization, recomputed from the
    program's own step outputs and values (the bootstrap value from its
    last observation), against its returns and advantages."""
    T = len(steps)
    N = obs_last.shape[0]
    dev = obs_last.device
    done = torch.stack([s[2].done for s in steps]).to(dev)
    timeout = torch.stack([s[2].timeout for s in steps]).to(dev)
    fed = {"obs": torch.stack([obs0] + [s[2].obs.to(dev) for s in steps[:-1]]),
           "actions": torch.stack([s[1] for s in steps]).to(dev),
           "rewards": torch.stack([s[2].reward for s in steps]).to(dev)}
    flags = {f"batch.{k}": _rows_wrong(prog[k].reshape(T * N, -1), x.reshape(T * N, -1), 0.0, 0.0)
             for k, x in fed.items()}
    with torch.no_grad():
        last = policy.value(obs_last)
    out = ref_drivers.PolicyOut(prog["actions"].view(T, N, -1), prog["log_probs"].view(T, N, -1),
                                prog["values"].view(T, N, -1))
    ref = ref_drivers.make_batch(prog["obs"].view(T, N, -1), out, prog["rewards"], done, timeout,
                                 last, config["gamma"], config["gae_lambda"])
    flags.update({f"batch.{k}": _rows_wrong(prog[k], ref[k], tol["policy"], tol["policy"])
                  for k in ("returns", "adv")})
    tally.add(flags, T * N)
    for k in ("returns", "adv"):
        tally.gap("batch", prog[k], ref[k])


def leaf_norms(flat: torch.Tensor, shapes: list) -> list:
    sizes = [int(torch.Size(s).numel()) for _, s in shapes]
    return [float(x.norm()) for x in flat.double().split(sizes)]


def leaf_gap(prog: list, ref: list, keep: list) -> float:
    """The worst leaf's gap between the two norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    median = statistics.median(r for r, k in zip(ref, keep) if k)
    return max(abs(p - r) / max(r, median) for p, r, k in zip(prog, ref, keep) if k)


def reference_update(config: dict, ppo_cfg, policy, shapes: list, params, adam: tuple,
                     batch: dict, perms, lr: float):
    """The reference's PPO update from the program's parameters and Adam
    state, at learning rate `lr`: (params after, AdamState after, loss)."""
    from benchmark.harness.system import load, flatten
    load(policy, params, shapes)
    opt = ref_ppo.AdamState(*(x.clone() for x in adam))
    opt, m = ref_ppo.ppo_update(policy, opt, ppo_cfg, batch, lr, perms=perms)
    return flatten(dict(policy.named_parameters()), shapes), opt, loss(config, tuple(m))


def loss(config: dict, metrics: tuple) -> float:
    """The update's mean loss: value loss x its weight + action loss -
    entropy x its weight (PPOMetrics order)."""
    value_loss, action_loss, entropy = (float(x) for x in metrics[:3])
    return (config["value_loss_coef"] * value_loss + action_loss
            - config["entropy_coef"] * entropy)
