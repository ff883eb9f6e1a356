"""One rank of the port's CPU run on a mesh (``gloo``), for
``tests/test_torch_mesh_numerics.py``:

    python tests/_torch_mesh_worker.py DIR RANK [WORLD]

reads ``DIR/inputs.pt`` (for each case: an arch, its smoke's (heads, KV
heads) and MoE config if they are changed, params and tokens, and
whether to check the Mamba mixer's pieces, :func:`units`, or K4's per
rank, :func:`wkv_units`), joins a
group of WORLD ranks (2 by default) through a ``FileStore`` in DIR, and
for each case on the ("data", "model") meshes of ``MESHES[WORLD]`` runs
the forward, prefill, 4 decode steps with ``seq_parallel`` off and on,
the loss (its aux term apart too), its gradient and one train step, with
params, state and inputs distributed by ``launch.mesh.shardings_for``.
Rank 0 writes the whole results to ``DIR/out.pt``.
"""
import dataclasses
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import sharding as sh
from repro_torch.core.config import OptimizerConfig, ShapeConfig, get_arch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.optim import adamw

DECODE_STEPS, MAX_LEN = 4, 8
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}


def smoke(arch, heads=None, moe=None):
    """The arch's smoke in f32, with (heads, KV heads) and changes to its
    MoE config when given."""
    cfg = get_arch(arch).smoke
    if heads:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, num_heads=heads[0], num_kv_heads=heads[1]))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def full(tree):
    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    return sh.full(tree).detach().clone()


def run(cfg, params, tokens, mesh, seq_parallel):
    B, S = tokens.shape
    out = {}
    with sh.activation_rules(mesh, seq_parallel=seq_parallel):
        train = ShapeConfig("t", S, B, "train")
        ins = {"tokens": tokens}
        # the test's optimizer: step 1 at the full learning rate
        opt_cfg = OptimizerConfig(warmup_steps=0, eps=1e-3)
        opt = adamw.init_opt_state(params, opt_cfg)
        specs = mesh_lib.shardings_for(cfg, train, mesh, params, opt, ins)
        p = sh.distribute_tree(params, specs["params"], mesh)
        batch = sh.distribute_tree(ins, specs["batch"], mesh)
        if not seq_parallel:
            with torch.no_grad():
                out["forward"] = full(api.forward(p, cfg, batch,
                                                  remat="none")[0])
                logits, cache = api.prefill(p, cfg, batch)
                out["prefill"] = full(logits)
                out["prefill_cache"] = full(cache)
            items = adamw.named_leaves(p)
            alias = {k: v.detach().requires_grad_() for k, v in items}
            loss, metrics = api.loss_fn(adamw.tree_like(p, alias), cfg,
                                        batch, remat="none")
            grads = torch.autograd.grad(loss, [alias[k] for k, _ in items])
            out["loss"] = full(loss)
            out["aux"] = full(metrics["aux"])
            out["grads"] = adamw.tree_like(p, {
                k: full(g.redistribute(v.device_mesh, v.placements))
                for (k, v), g in zip(items, grads)})
            step = steps.make_train_step(cfg, opt_cfg, remat="none")
            o = sh.distribute_tree(opt, specs["opt_state"], mesh)
            p2, _, metrics = step(p, o, batch)
            out["trained"] = full(p2)
            out["grad_norm"] = full(metrics["grad_norm"])
        shape = ShapeConfig("d", MAX_LEN, B, "decode")
        dins = {"tokens": tokens[:, 0],
                "state": api.allocate_decode_state(cfg, B, MAX_LEN, "cpu")}
        specs = mesh_lib.shardings_for(cfg, shape, mesh, params, None, dins,
                                       seq_parallel=seq_parallel)
        state = sh.distribute_tree(dins["state"], specs["state"], mesh)
        p = sh.distribute_tree(params, specs["params"], mesh)   # untrained
        # the layouts of the first attention, Mamba and RWKV layers' caches
        subs = specs["state"]["periods"].values()
        attn = next((c["attn"] for c in subs if "attn" in c), None)
        if attn is not None:
            out["state_spec"] = attn["k"]
        ssm = next((c["ssm"] for c in subs if "ssm" in c), None)
        if ssm is not None:
            out["ssm_spec"] = (ssm["conv"], ssm["state"])
        rwkv = next((c["rwkv_tm"] for c in subs if "rwkv_tm" in c), None)
        if rwkv is not None:
            out["rwkv_spec"] = (rwkv["wkv"], rwkv["shift_t"], rwkv["shift_c"])
        logits = []
        with torch.no_grad():
            for i in range(DECODE_STEPS):
                tok = sh.distribute(tokens[:, i], specs["tokens"], mesh)
                lg, state = api.decode_step(p, cfg, state, tok,
                                            torch.tensor(i, dtype=torch.int32))
                logits.append(full(lg))
        out["decode"] = torch.stack(logits)
    return out


def units(cfg, mesh):
    """The Mamba mixer's pieces on one mesh (the case's ``"units"``): the
    u/z split against the reference's slices on each rank, K3's plain
    version on each rank's channels against the whole scan (dB and dC the
    sum of the ranks' shares), and a decode step's state written into the
    cache's own local shard.  Returns every result whole, and each rank's
    own checks reduced over the ranks."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_by_channels
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import ssm as SSM

    g = torch.Generator().manual_seed(3)
    Bz, S, di, ds = 2, 8, SSM.d_inner_of(cfg), cfg.ssm.d_state
    out = {}
    with sh.activation_rules(mesh):
        # in_proj's output, laid out as the product leaves it
        xz = torch.randn(Bz, S, 2 * di, generator=g)
        u, z = SSM._split_uz(sh.distribute(
            xz, sh.spec_for(("batch", None, "mlp"), xz.shape, mesh), mesh),
            di)
        # this rank's batch rows and channels of u and of z
        (nr, _, nc), (r0, _, c0) = sh.local_extent(u.shape, u.placements, mesh)
        mine = (xz[r0:r0 + nr, :, c0:c0 + nc],
                xz[r0:r0 + nr, :, di + c0:di + c0 + nc])
        out["split"] = (full(u), full(z))
        out["split_local_err"] = max(
            float((t.to_local() - w).abs().max()) for t, w in zip((u, z), mine))
        out["split_placements"] = (str(u.placements), str(z.placements))

        # K3's plain version on each rank's channels, and its gradients
        ins = {"u": torch.randn(Bz, S, di, generator=g),
               "dt": torch.rand(Bz, S, di, generator=g) * 0.5,
               "A_log": torch.randn(di, ds, generator=g) * 0.5,
               "B": torch.randn(Bz, S, ds, generator=g),
               "C": torch.randn(Bz, S, ds, generator=g),
               "D": torch.randn(di, generator=g)}
        dy = torch.randn(Bz, S, di, generator=g)
        leaves = {k: v.clone().requires_grad_() for k, v in ins.items()}
        y, h = ssm_scan_ref(*(leaves[k] for k in ("u", "dt", "A_log", "B",
                                                  "C", "D")),
                            torch.zeros(Bz, di, ds))
        (y * dy).sum().backward()
        out["scan_want"] = {"y": y.detach(), "h": h.detach(),
                            **{k: v.grad for k, v in leaves.items()}}
        chan = sh.spec_for(("batch", None, "mlp"), (Bz, S, di), mesh)
        rep = sh.spec_for(("batch", None, None), (Bz, S, ds), mesh)
        specs = {"u": chan, "dt": chan, "A_log": (None, None), "B": rep,
                 "C": rep, "D": (None,)}
        dist_in = {k: sh.distribute(v, specs[k], mesh).requires_grad_()
                   for k, v in ins.items()}
        y, h = ssm_scan_by_channels(*(dist_in[k] for k in (
            "u", "dt", "A_log", "B", "C", "D")))
        (y * sh.distribute(dy, chan, mesh)).sum().backward()
        out["scan_got"] = {"y": full(y), "h": full(h), **{
            k: full(v.grad.redistribute(v.device_mesh, v.placements))
            for k, v in dist_in.items()}}

        # a decode step's state written into the cache's local storage
        state = torch.randn(Bz, di, ds, generator=g)
        cache = sh.distribute(state, sh.spec_for(
            ("batch", "mlp", None), state.shape, mesh), mesh)
        step = {k: (v[:, :1] if v.dim() == 3 else v).contiguous()
                for k, v in ins.items()}
        with torch.no_grad():
            want_y, want_h = ssm_scan_ref(*(step[k] for k in (
                "u", "dt", "A_log", "B", "C", "D")), state)
            ptr = cache.to_local().data_ptr()
            y, h = ssm_scan_by_channels(
                *(sh.distribute(step[k], specs[k], mesh) for k in (
                    "u", "dt", "A_log", "B", "C", "D")), cache,
                in_place=True)
        same = isinstance(h, DTensor) and h.to_local().data_ptr() == ptr \
            and cache.to_local().data_ptr() == ptr
        out["decode_y"], out["decode_state"] = full(y), full(cache)
        out["decode_want"] = (want_y, want_h)
        flag = torch.tensor([float(same), out["split_local_err"]])
        flags = [torch.zeros(2) for _ in range(dist.get_world_size())]
        dist.all_gather(flags, flag)
        out["in_place_all_ranks"] = all(bool(f[0]) for f in flags)
        out["split_local_err"] = max(float(f[1]) for f in flags)
    return out


def wkv_units(cfg, mesh):
    """K4 per rank on one mesh (the case's ``"units"`` for an RWKV arch):
    ``rwkv6_scan_by_heads`` on each rank's rows and heads against the op on
    the whole tensors, forward and gradients (du the sum of the ranks'
    shares), and the time mix's decode step, its state written into the
    cache's own local shards.  Returns every result whole, and whether
    every rank's cache kept its storage."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan_by_heads
    from repro_torch.models import rwkv6 as R6

    g = torch.Generator().manual_seed(4)
    Bz, S, H, hd = 2, 8, R6.num_heads_of(cfg), cfg.rwkv.head_dim
    ins = {"r": torch.randn(Bz, H, S, hd, generator=g),
           "k": torch.randn(Bz, H, S, hd, generator=g),
           "v": torch.randn(Bz, H, S, hd, generator=g),
           "logw": -torch.exp(torch.randn(Bz, H, S, hd, generator=g) * 0.5),
           "u": torch.randn(H, hd, generator=g) * 0.1}
    names = ("r", "k", "v", "logw", "u")
    dy = torch.randn(Bz, H, S, hd, generator=g)
    dstate = torch.randn(Bz, H, hd, hd, generator=g)
    out = {}
    leaves = {k: v.clone().requires_grad_() for k, v in ins.items()}
    y, state = rwkv6_scan_by_heads(*(leaves[k] for k in names))
    ((y * dy).sum() + (state * dstate).sum()).backward()
    out["scan_want"] = {"y": y.detach(), "state": state.detach(),
                        **{k: v.grad for k, v in leaves.items()}}
    tm = R6.init_time_mix(torch.Generator().manual_seed(5), cfg)
    x = torch.randn(Bz, 1, cfg.d_model, generator=g)
    cache0 = {"shift_t": torch.randn(Bz, cfg.d_model, generator=g),
              "wkv": torch.randn(Bz, H, hd, hd, generator=g) * 0.1}
    with torch.no_grad():
        want_y, want_state = R6.apply_time_mix(
            tm, x, cfg, mode="decode",
            cache={k: v.clone() for k, v in cache0.items()})
    with sh.activation_rules(mesh):
        heads = sh.spec_for(("batch", "heads", None, None), (Bz, H, S, hd),
                            mesh)
        specs = dict.fromkeys(names[:4], heads)
        specs["u"] = (None, None)
        dist_in = {k: sh.distribute(v, specs[k], mesh).requires_grad_()
                   for k, v in ins.items()}
        y, state = rwkv6_scan_by_heads(*(dist_in[k] for k in names))
        ((y * sh.distribute(dy, heads, mesh)).sum()
         + (state * sh.distribute(dstate, heads, mesh)).sum()).backward()
        out["scan_got"] = {"y": full(y), "state": full(state), **{
            k: full(v.grad.redistribute(v.device_mesh, v.placements))
            for k, v in dist_in.items()}}
        out["placements"] = str(y.placements)

        # a decode step of the time mix: its closed form on each rank's
        # heads, the new state copied into the cache's own local shards
        with torch.no_grad():
            cache = sh.distribute_tree(cache0, sh.state_pspecs(cache0, mesh),
                                       mesh)
            ptrs = {k: v.to_local().data_ptr() for k, v in cache.items()}
            y, state = R6.apply_time_mix(
                sh.distribute_tree(tm, sh.param_pspecs(tm, mesh), mesh),
                sh.distribute(x, sh.spec_for(("batch", "seq", "embed"),
                                             x.shape, mesh), mesh),
                cfg, mode="decode", cache=cache)
        same = all(isinstance(state[k], DTensor)
                   and state[k].to_local().data_ptr() == ptr
                   == cache[k].to_local().data_ptr()
                   for k, ptr in ptrs.items())
        out["decode_y"], out["decode_state"] = full(y), full(cache)
        out["decode_want"] = (want_y, want_state)
        flags = [torch.zeros(1) for _ in range(dist.get_world_size())]
        dist.all_gather(flags, torch.tensor([float(same)]))
        out["in_place_all_ranks"] = all(bool(f[0]) for f in flags)
    return out


def main(path, rank, world=2):
    dist.init_process_group("gloo", store=dist.FileStore(f"{path}/store",
                                                         world),
                            rank=rank, world_size=world)
    data = torch.load(f"{path}/inputs.pt")
    results = {}
    meshes = {dims: init_device_mesh("cpu", dims,
                                     mesh_dim_names=("data", "model"))
              for dims in MESHES[world]}
    for case, d in data.items():
        cfg = smoke(d["arch"], d["heads"], d["moe"])
        for dims, mesh in meshes.items():
            name = f"{case}:{dims[0]}x{dims[1]}"
            for sp in (False, True):
                results[f"{name}:sp{int(sp)}"] = run(
                    cfg, d["params"], d["tokens"], mesh, sp)
            if d.get("units"):
                results[f"{name}:units"] = (
                    wkv_units if cfg.family == "ssm" else units)(cfg, mesh)
    if rank == 0:
        torch.save(results, f"{path}/out.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:]))
