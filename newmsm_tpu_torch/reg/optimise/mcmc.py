"""Monte-Carlo label optimisation over triplets (mcmc_opt.h:29-134), in
parallel over conflict-free colour groups.

Port of newmsm_tpu/reg/optimise/mcmc.py. The reference sweeps triplets
sequentially, greedily taking the best of the 8 keep/replace combinations
of one geometric-distributed proposal per triplet. Here each sweep
processes colour groups of triplets in parallel (faces in a group share no
vertex), with updates visible across groups inside the sweep: the same
greedy dynamics, deterministic under a seeded generator.

The cost volume and the unary rows are indexed directly
(`tcosts[t, la, lb, lc]`, `urows[node, label]`); the values are those of
the JAX package's one-hot row selections.

Random numbers: the JAX package draws its proposals from jax.random
(threefry), which torch cannot reproduce. Here the uniforms come from an
explicit torch.Generator, one (n_colors, G, R) draw per sweep; `draws`
injects the proposals of every sweep instead, which lets a test feed both
packages the same ones.
"""
from __future__ import annotations

from typing import Optional

import torch


def truncated_geometric(u, p, num_labels: int):
    """Geometric(p) truncated to [0, num_labels) from uniforms `u` in [0,1):
    the reference redraws until label < num_labels (mcmc_opt.h:52);
    inverse-CDF sampling of the conditioned distribution is equivalent.
    Returns int64 labels shaped like u."""
    q = torch.tensor(1.0 - p, dtype=u.dtype, device=u.device)
    total = 1.0 - torch.pow(q, num_labels)
    k = torch.floor(torch.log1p(-u * total) / torch.log(q)).to(torch.int64)
    return k.clamp(0, num_labels - 1)


def n_sweeps_for(mciters: int, proposals: int) -> int:
    """Sweeps that retire `mciters` per-triplet draws, `proposals` a step."""
    return -(-mciters // proposals)


def mcmc_optimise(labeling, unary, tcosts, triplets, groups, group_mask,
                  generator: Optional[torch.Generator] = None, *,
                  mciters: int, num_labels: int, dist_param=0.8,
                  proposals: int = 1, draws: Optional[torch.Tensor] = None):
    """Run `mciters` per-triplet proposal draws (the reference's sweep
    count, mesh_registration.cpp:712).

    labeling: (K,) int64; unary: (L,K) label-major as the reference stores
    it; tcosts: (T,L,L,L); triplets: (T,3); groups/group_mask: (C,G)
    triplet ids per colour, padded. Returns the final labeling.

    `proposals` (R): evaluate R geometric draws per triplet per colour step
    and greedily take the best of the R*8 keep/replace combinations (the
    first on ties). R=1 is the reference's one-draw-per-sweep schedule; R>1
    draws the same distribution in blocks (greedy best-of-block instead of
    greedy per-draw: equal or lower energy per draw).

    The proposals of sweep i are `draws[i]` ((n_sweeps, C, G, R) labels)
    when given, else truncated-geometric labels from one uniform draw of
    `generator` (made on the generator's device, then moved to the
    labeling's)."""
    n_colors, G = groups.shape
    L = num_labels
    R = proposals
    n_sweeps = n_sweeps_for(mciters, R)
    dev = labeling.device
    if draws is None and generator is None:
        raise ValueError("mcmc_optimise: a torch.Generator or draws is "
                         "required")
    if draws is not None and tuple(draws.shape) != (n_sweeps, n_colors, G, R):
        raise ValueError(f"mcmc_optimise: draws must be "
                         f"{(n_sweeps, n_colors, G, R)}, got "
                         f"{tuple(draws.shape)}")

    # static per-call tables: per colour, the real (unpadded) triplets.
    # Padding is dropped here, so the label write below needs no mask.
    slots = [torch.nonzero(group_mask[c])[:, 0] for c in range(n_colors)]
    tids = [groups[c][sl] for c, sl in enumerate(slots)]       # (g,)
    corners = [triplets[t] for t in tids]                      # (g,3)
    urows = unary.T.contiguous()                               # (K,L)
    labeling = labeling.clone()

    for i in range(n_sweeps):
        if draws is not None:
            props = draws[i].to(device=dev, dtype=torch.int64)
        else:
            u = torch.rand((n_colors, G, R), generator=generator,
                           device=generator.device)
            props = truncated_geometric(u, dist_param, L).to(dev)
        for c in range(n_colors):
            prop = props[c][slots[c]]                          # (g,R)
            nabc = corners[c]                                  # (g,3)
            t = tids[c]
            cur = labeling[nabc]                               # (g,3)
            # per corner the 2 candidate labels of each draw: (g,R,2)
            la2, lb2, lc2 = (torch.stack(
                [cur[:, k:k + 1].expand_as(prop), prop], -1)
                for k in range(3))
            # the {cur,p_r}^3 cube of costs: (g,R,2,2,2)
            tc = tcosts[t[:, None, None, None, None],
                        la2[:, :, :, None, None],
                        lb2[:, :, None, :, None],
                        lc2[:, :, None, None, :]]
            ua = urows[nabc[:, 0, None, None], la2]            # (g,R,2)
            ub = urows[nabc[:, 1, None, None], lb2]
            uc = urows[nabc[:, 2, None, None], lc2]
            un = (ua[..., :, None, None] + ub[..., None, :, None]
                  + uc[..., None, None, :]) / 3.0
            # combo bit order (a,b,c): idx = r*8 + a*4 + b*2 + c, bit = 1
            # takes draw r's proposal; argmin returns the first minimum
            best = torch.argmin((tc + un).reshape(t.shape[0], R * 8), dim=1)
            combo = best % 8
            bits = torch.stack([combo // 4, (combo // 2) % 2, combo % 2], 1)
            p_sel = torch.gather(prop, 1, (best // 8)[:, None])  # (g,1)
            newl = torch.where(bits == 1, p_sel.expand(-1, 3), cur)
            # corners within a colour are disjoint: no duplicate index
            labeling[nabc.reshape(-1)] = newl.reshape(-1)
    return labeling


def total_energy(labeling, unary, tcosts, triplets):
    """evaluateTotalCostSum for the triplet MRF
    (DiscreteCostFunction.cpp:55-77). unary is (L,K) label-major."""
    K = labeling.shape[0]
    un = unary[labeling, torch.arange(K, device=unary.device)].sum()
    tc = tcosts[torch.arange(triplets.shape[0], device=tcosts.device),
                labeling[triplets[:, 0]], labeling[triplets[:, 1]],
                labeling[triplets[:, 2]]].sum()
    return un + tc
