"""Rank code of the spatial-inference tests (no tests of its own, and no
JAX: spawned ranks import this module).

``run_ranks(world, out_dir, jobs)`` runs ``rank_main`` in ``world``
spawned CPU processes joined in one gloo group (the port's
``parallel.launch.spawn``, torch on one thread per rank) and returns each
rank's results: every primitive case of ``primitive_cases`` on the
width-sharded mesh, gathered back to the whole tensor, and for each graph
job (a frame and a serving variant of ``VARIANTS``) the spatial
deployment graph's outputs, fused and unfused, from the frame and from
fed stage inputs.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn.functional as F

from creste_public_tpu_torch.models.blocks.convnets import (
    promoted,
    same_padding,
)
from creste_public_tpu_torch.models.blocks.resnet import merge_decoder_heads
from creste_public_tpu_torch.parallel import launch
from creste_public_tpu_torch.parallel import spatial as sp
from creste_public_tpu_torch.runtime.export import (
    build_inference_graph,
    build_spatial_inference_fn,
)

REWARD = "traversability_preds"
H = 7  # rows of the primitive cases (odd: stride 2 meets SAME padding)
C = 8
WIDTHS = (80, 77, 3)


def _same(w: int, k: int, s: int) -> tuple[int, int, int, int]:
    return (*same_padding(H, k, s), *same_padding(w, k, s))


# name -> (kernel, stride, padding (top, bottom, left, right) or "same",
# groups)
CONVS = {
    "conv1x1": (1, 1, (0, 0, 0, 0), 1),
    "conv3x3": (3, 1, (1, 1, 1, 1), 1),
    "conv5x5": (5, 1, (2, 2, 2, 2), 1),
    "conv3x3_s2_pad01": (3, 2, (0, 1, 0, 1), 1),
    "conv5x5_s2_pad12_depthwise": (5, 2, (1, 2, 1, 2), C),
    "conv3x3_depthwise": (3, 1, (1, 1, 1, 1), C),
    "conv5x5_s2_same": (5, 2, "same", 1),
    "conv1x1_s2": (1, 2, (0, 0, 0, 0), 1),
    "conv7x7_s2": (7, 2, (3, 3, 3, 3), 1),
}
OTHERS = ("maxpool2", "resize_x2", "resize_2w_minus_1", "mean")


def primitive_cases(seed: int = 0) -> list[dict]:
    """Every primitive at every width of ``WIDTHS``: its name, input
    [2, C, H, w] and, for a convolution, weights N(0, 1/fan_in) and a
    bias, from a seeded generator (the same in every process); and at
    width 77 each op of ``OTHERS`` and a 3x3 convolution in bf16, and the
    convolution's bf16 weights on an f32 input."""
    g = torch.Generator().manual_seed(seed)
    cases = []
    for w in WIDTHS:
        for name, (k, s, pad, groups) in CONVS.items():
            fan_in = C // groups * k * k
            cases.append(dict(
                name=f"{name}_w{w}", op="conv", w=w,
                x=torch.randn(2, C, H, w, generator=g),
                weight=torch.randn(C, C // groups, k, k, generator=g)
                / fan_in ** 0.5,
                bias=0.1 * torch.randn(C, generator=g), stride=(s, s),
                pad=_same(w, k, s) if pad == "same" else pad, groups=groups))
        for name in OTHERS:
            cases.append(dict(name=f"{name}_w{w}", op=name, w=w,
                              x=torch.randn(2, C, H, w, generator=g)))
    # a bf16 stream: its resizes and means accumulate in f32 and round
    # once, its convolutions promote (a bf16 weight on an f32 island
    # computes in f32)
    w = WIDTHS[1]
    for name in OTHERS + ("conv3x3", "conv3x3_f32_input"):
        x = torch.randn(2, C, H, w, generator=g)
        case = dict(name=f"{name}_w{w}_bf16", op=name, w=w,
                    x=x if name.endswith("f32_input") else x.bfloat16())
        if name.startswith("conv"):
            case.update(op="conv", stride=(1, 1), pad=(1, 1, 1, 1),
                        groups=1, bias=(0.1 * torch.randn(
                            C, generator=g)).bfloat16(),
                        weight=(torch.randn(C, C, 3, 3, generator=g)
                                / (9 * C) ** 0.5).bfloat16())
        cases.append(case)
    return cases


def _resize_size(case: dict) -> tuple[int, int]:
    if case["op"] == "resize_x2":
        return 2 * H, 2 * case["w"]
    return 2 * H - 1, 2 * case["w"] - 1


def unsharded(case: dict) -> torch.Tensor:
    """The primitive on the whole tensor."""
    x = case["x"]
    if case["op"] == "conv":
        t, b, l, r = case["pad"]
        x, w, bias = promoted(F.pad(x, (l, r, t, b)), case["weight"],
                              case["bias"])
        return F.conv2d(x, w, bias, case["stride"], 0, 1, case["groups"])
    if case["op"] == "maxpool2":
        return F.max_pool2d(x, 2, 2)
    if case["op"] == "mean":
        return x.mean(dim=(2, 3), keepdim=True)
    return F.interpolate(x, size=_resize_size(case), mode="bilinear",
                         align_corners=False)


def sharded(case: dict, mesh: sp.SpatialMesh) -> torch.Tensor:
    """The primitive on this rank's columns, gathered back."""
    lo, hi = mesh.columns(case["w"])
    x = sp.Strip(case["x"][..., lo:hi], case["w"])
    if case["op"] == "conv":
        y = sp.conv2d(x, case["weight"], case["bias"], case["stride"],
                      case["pad"], case["groups"], mesh)
    elif case["op"] == "maxpool2":
        y = sp.max_pool2d(x, 2, 2, mesh)
    elif case["op"] == "mean":
        return sp.mean_hw(x, mesh)
    else:
        y = sp.resize_bilinear(x, _resize_size(case), mesh)
    return sp.gather_columns(y.t, y.width, -1, mesh)


# the serving variants of the deployment graph: build_inference_graph's
# fold_bn and compute_dtype, the decoder's merged heads (the state's heads
# rewritten by merge_decoder_heads) and the splat's mode
VARIANTS = {
    "f32": {},
    "fold_bn": {"fold_bn": True},
    "bf16": {"compute_dtype": "bfloat16"},
    "bf16_fold_bn": {"compute_dtype": "bfloat16", "fold_bn": True},
    "merged_heads": {"merged_heads": True},
    "max_splat": {"scatter_mode": "max"},
}
DECODER = "backbone.bevclassifier."


def variant_config(cfg: dict, state: dict, variant: str
                   ) -> tuple[dict, dict, dict]:
    """(config, state, graph options) of ``variant`` from an f32 config and
    state: merged heads set in the decoder's ``net_kwargs`` with its heads'
    tensors merged; the rest are ``build_inference_graph``'s options and
    the splat's mode (``scatter_mode``)."""
    opts = dict(VARIANTS[variant])
    if opts.pop("merged_heads", False):
        vb = dict(cfg["vision_backbone"])
        bev = dict(vb["bev_classifier"])
        bev["net_kwargs"] = dict(bev["net_kwargs"], merged_heads=True)
        vb["bev_classifier"] = bev
        cfg = dict(cfg, vision_backbone=vb)
        state = merge_decoder_heads(state, bev["net_kwargs"]["num_classes"],
                                    DECODER)
    return cfg, state, opts


def variant_graph(job: dict, fused: bool, device: str = "cpu"):
    """The one-rank ``InferenceGraph`` of a job's variant (its config,
    state and options from ``variant_config``)."""
    opts = dict(job.get("opts", {}))
    mode = opts.pop("scatter_mode", None)
    graph = build_inference_graph(job["cfg"], job["state"], device, fused,
                                  **opts)
    if mode is not None:
        graph.model.backbone.cam2map.scatter_mode = mode
    return graph


def is_bf16(job: dict) -> bool:
    return job.get("opts", {}).get("compute_dtype") is not None


def gemm_convolutions():
    """oneDNN off for the block: the CPU's convolutions go through torch's
    im2col GEMM, which sums every output in the same order at any input
    width (a strip's outputs equal the frame's to the bit), where oneDNN
    picks its algorithm by the width."""
    return torch.backends.mkldnn.flags(enabled=False)


def _gathered(outputs: dict, mesh) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone()
            for k, v in sp.gather_outputs(outputs, mesh).items()}


def _strip(t: torch.Tensor, mesh) -> sp.Strip:
    """This rank's columns of an NHWC map [B, N, H, W, C], as an NCHW
    strip of the B * N frames."""
    B, N, H, W, C = t.shape
    lo, hi = mesh.columns(W)
    return sp.Strip(t[:, :, :, lo:hi].reshape(B * N, H, hi - lo, C)
                    .permute(0, 3, 1, 2).contiguous(), W)


def from_backbone(model, fed: dict, p2p: torch.Tensor, mesh,
                  tensors) -> dict[str, torch.Tensor]:
    """The spatial graph after the image backbone (``bev_graph``) from this
    rank's columns of the fed metric depth [B, N, Hs, Ws] and features
    [B, N, Hs, Ws, Z], gathered."""
    depth, feats = fed["depth"], fed["feats"]
    lo, hi = mesh.columns(depth.shape[-1])
    return _gathered(sp.bev_graph(
        model, depth[..., lo:hi].contiguous(),
        feats[..., lo:hi, :].contiguous(), p2p, depth.shape[-1], mesh,
        tensors), mesh)


@torch.no_grad()
def fed_stages(model, fed: dict, p2p: torch.Tensor, mesh,
               tensors) -> dict[str, dict[str, torch.Tensor]]:
    """Each stage of the spatial graph after the trunk, from this rank's
    columns of a one-rank graph's input to it (``fed``: its trunk
    features ``feats``, metric depth ``depth``, BEV grid ``bev`` and,
    when given, input view ``iv``), gathered: ``heads`` (the depth and
    DINO heads, from the features), ``splat`` (and after it, from the
    depth and the features), ``bev`` (the decoder and the reward, from the
    grid), ``reward`` (the reward head and its full map, from the input
    view)."""
    dist_bb = model.backbone.depthcomp
    B, N = fed["feats"].shape[:2]
    feats = _strip(fed["feats"], mesh)
    heads = sp.predict_depth(dist_bb.depthcomp, feats, mesh)
    heads["dino_pe_feats"] = sp.dino_head(dist_bb, feats, B, N, mesh)
    out = {"heads": _gathered(heads, mesh),
           "splat": from_backbone(model, fed, p2p, mesh, tensors),
           "bev": _gathered(sp.bev_heads(model, fed["bev"], mesh, tensors),
                            mesh)}
    if fed.get("iv") is not None:
        iv = _strip(fed["iv"][:, None], mesh)
        out["reward"] = _gathered(sp.reward_from_view(
            model.traversability_head, iv, fed["bev"].shape[1:3], mesh,
            tensors), mesh)
    return out


def graph_results(job: dict, fused: bool, mesh) -> dict:
    """The spatial graph of ``job`` (config, state, variant, frame, fed
    stage inputs), built from the variant's one-rank ``InferenceGraph``
    and gathered: ``e2e`` from the frame through
    ``build_spatial_inference_fn``, ``jax_stages`` (``fed_stages``) from
    the JAX graph's inputs to each stage (when the job has them), and
    ``fed_stages`` from the one-rank graph's: for an f32 variant with
    oneDNN off (``gemm_convolutions``), where ``e2e_gemm`` is the frame's
    too; a bf16 stream with oneDNN on (torch's bf16 GEMM is ~100x slower
    than oneDNN's on the CPU)."""
    graph = variant_graph(job, fused)
    fn = build_spatial_inference_fn(graph, mesh, device="cpu")
    model = graph.model
    tensors = graph.head_tensors() if fused else None
    p2p = torch.as_tensor(job["p2p"])
    res = {"e2e": fn(job["rgbd"], job["p2p"])}
    if job.get("jax_fed") is not None:
        res["jax_stages"] = fed_stages(model, job["jax_fed"], p2p, mesh,
                                       tensors)
    if is_bf16(job):
        res.update(fed_stages(model, job["fed"], p2p, mesh, tensors))
        return res
    with gemm_convolutions():
        res["e2e_gemm"] = fn(job["rgbd"], job["p2p"])
        res.update(fed_stages(model, job["fed"], p2p, mesh, tensors))
    return res


def rank_main(rank: int, jobs: dict) -> dict:
    """One rank: the primitive cases, each graph job fused and unfused,
    the message of ``make_spatial_mesh(world + 1)``, the first job's
    reward on a mesh of rank 0 alone (``make_spatial_mesh(1)``) and its
    fused graph with ``output_keys`` the reward alone."""
    mesh = sp.make_spatial_mesh()
    out = {"prims": {c["name"]: sharded(c, mesh) for c in primitive_cases()},
           "graphs": {(name, fused): graph_results(job, fused, mesh)
                      for name, job in jobs.items()
                      for fused in (True, False)},
           "mesh": (mesh.size, mesh.rank)}
    try:
        sp.make_spatial_mesh(mesh.size + 1)
        out["too_many"] = None
    except ValueError as e:
        out["too_many"] = str(e)
    # a mesh over the first rank alone: a subgroup every rank makes, which
    # runs the graph on rank 0 and refuses it elsewhere
    sub = sp.make_spatial_mesh(1)
    out["sub"] = (sub.size, sub.rank)
    job = next(iter(jobs.values()))
    try:
        fn = build_spatial_inference_fn(variant_graph(job, True), sub,
                                        device="cpu")
        out["sub_reward"] = fn(job["rgbd"], job["p2p"])[
            "traversability_preds"]
    except ValueError as e:
        out["sub_reward"] = str(e)
    # the first job's reward alone: the other outputs are not gathered
    fn = build_spatial_inference_fn(variant_graph(job, True), mesh,
                                    output_keys=(REWARD,), device="cpu")
    out["reward_only"] = fn(job["rgbd"], job["p2p"])
    return out


def _rank_entry(out_dir: str, jobs: dict) -> None:
    torch.set_num_threads(1)
    r = dist.get_rank()
    torch.save(rank_main(r, jobs), os.path.join(out_dir, f"rank{r}.pt"))


def run_ranks(world: int, out_dir, jobs: dict) -> list[dict]:
    """``rank_main`` of each of ``world`` spawned gloo ranks."""
    os.makedirs(out_dir, exist_ok=True)
    launch.spawn(_rank_entry, world, "cpu", str(out_dir), jobs)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
