"""Step functions of the LM path: the port of ``repro.launch.steps``.

train_step   — ONE federated round per call (the paper's Algorithm 1 on
               an LM): G cohorts from the batch's leading axis, each
               running L local SGD steps (f32 gradients accumulated over
               microbatches), FedAvg as the mean over G, then the split-FL
               path: hidden states at the split layer, PCA + K-means
               selection per cohort, meta-training of the upper part on
               the selected sequences, compose. The reference ``vmap``s
               the cohorts over a mesh; on one device the port runs them
               one after another.
prefill_step — causal forward over the prompt (after the encoder's pass
               or the vision prefix, where the batch has them),
               last-position logits only; the KV cache is not filled
               (as in the reference).
decode_step  — one token against the (ring-buffer) cache, greedy argmax;
               the cache is updated in place and returned.

Inference computes in ``dtype`` (bf16 by default, as the reference) and
runs without autograd; training computes in ``TrainConfig.dtype`` on f32
master weights, whose gradients come back f32 through the casts.
"""
from __future__ import annotations

from typing import Any, Sequence, Union

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import selection as sel
from repro_torch.models import layers as L
from repro_torch.models.transformer import LM, split_stages, unpack_batch
from repro_torch.optim.optimizers import sgd, tree_map, value_and_grad

PyTree = Any
# each cohort's K-means first centre: a (G,) index tensor or sequence, or a
# torch.Generator (a uniform row of the cohort's probe batch each)
FirstCentres = Union[torch.Tensor, Sequence[int], torch.Generator]


def _dtype(tcfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if tcfg.dtype == "bfloat16" else torch.float32


def _first_centre(first: FirstCentres, g: int, rows: int) -> int:
    if isinstance(first, torch.Generator):
        return int(torch.randint(rows, (1,), generator=first))
    return int(first[g])


def tree_stack(trees: Sequence[PyTree]) -> PyTree:
    """One tree whose leaves stack the trees' leaves on a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# --------------------------------------------------------------------------
# train: one federated round per call
# --------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """-> (train_step, lm). ``train_step(client_params, opt_state, batch,
    first) -> (new_client_params, opt_state, metrics)``:

    * ``client_params``: the full model's tree with a leading cohort axis
      G on every leaf (f32 master weights); ``opt_state`` the optimizer's
      state stacked the same way (``()`` for plain SGD);
    * ``batch``: {"tokens": (G, L, n_micro, mb, T) int} and, as the model
      takes them, the reference's extras beside them, (G, L, n_micro, mb,
      ...): "prefix_embeds" (..., P, d) for a VLM, "enc_frames" (..., Se,
      d) for an encoder-decoder (any other key raises ``ValueError``);
    * ``first``: with ``split_fl``, each cohort's K-means first centre (see
      ``FirstCentres``; the reference draws it from its key);
    * ``metrics``: {"loss", and with ``split_fl`` "meta_loss",
      "selected"}, 0-d tensors.

    Every cohort leaves the round with W_G(t), the composed model (the
    returned leaves are views of one tree)."""
    opt = sgd(tcfg.lr, momentum=tcfg.momentum,
              weight_decay=tcfg.weight_decay)
    dt = _dtype(tcfg)
    # split boundary (stage-aligned) for the split-FL metadata path
    lm_split = LM(cfg, remat=tcfg.remat)
    lm_split.stages, boundary_stage = split_stages(cfg, cfg.split_layer)
    n_stages = len(lm_split.stages)

    def local_loss(p, batch):
        return lm_split.loss(p, batch, dtype=dt)

    def one_cohort(params, opt_state, tokens, extras):
        """L local steps (each over microbatches with f32 gradient
        accumulation; each microbatch with its extras) -> (params,
        opt_state, mean loss)."""
        step_losses = []
        for li, tok_mb in enumerate(tokens):   # (n_micro, mb, T) a step
            g_sum, losses = None, []
            for mi, t in enumerate(tok_mb):
                batch = dict(tokens=t,
                             **{k: v[li, mi] for k, v in extras.items()})
                loss, g = value_and_grad(local_loss, params, batch)
                g = tree_map(lambda x: x.to(torch.float32), g)
                g_sum = g if g_sum is None else tree_map(torch.add, g_sum, g)
                losses.append(loss)
            n_micro = tok_mb.shape[0]
            # (g / 1 is g: no copy of the gradients for one microbatch)
            g_mean = (g_sum if n_micro == 1
                      else tree_map(lambda x: x / n_micro, g_sum))
            params, opt_state = opt.apply(g_mean, opt_state, params)
            step_losses.append(torch.stack(losses).mean())
        return params, opt_state, torch.stack(step_losses).mean()

    def select_cohort(params, probe, probe_ex, first_row):
        """§3.1 on one cohort: the hidden states of its probe batch (with
        its extras) at the split (computed from the cohort's new weights),
        mean-pooled over the T (+ P) positions, PCA + K-means over all rows
        -> the selected (acts, tokens, extras, valid)."""
        with torch.no_grad():
            acts, _, _ = lm_split.apply(params, probe, mode="full",
                                        stage_range=(0, boundary_stage),
                                        dtype=dt, **probe_ex)
            s_ = sel.select_metadata(                      # (mb, T(+P), d)
                acts.mean(1), None, first_row, per_class=False,
                clusters_per_class=tcfg.meta_clusters,
                pca_components=min(tcfg.pca_components, probe.shape[0] - 1),
                kmeans_iters=8)
            idx = s_.indices
            return (acts[idx], probe[idx],
                    {k: v[idx] for k, v in probe_ex.items()}, s_.valid)

    def train_step(client_params, opt_state, batch, first=None):
        tokens, extras = unpack_batch(batch)
        if tcfg.split_fl and first is None:
            raise ValueError("train_step: split_fl needs each cohort's "
                             "K-means first centre (first=...)")
        g_ax = tokens.shape[0]
        new_p, new_s, losses, selected = [], [], [], []
        for g in range(g_ax):
            p = tree_map(lambda x: x[g], client_params)
            s = tree_map(lambda x: x[g], opt_state) if opt_state else ()
            p, s, loss = one_cohort(p, s, tokens[g],
                                    {k: v[g] for k, v in extras.items()})
            new_p.append(p)
            new_s.append(s)
            losses.append(loss)
            if tcfg.split_fl:
                # the probe: each cohort's first microbatch of its first
                # local step (and its extras), read by the cohort's new
                # weights
                probe = tokens[g, 0, 0]                    # (mb, T)
                probe_ex = {k: v[g, 0, 0] for k, v in extras.items()}
                selected.append(select_cohort(
                    p, probe, probe_ex,
                    _first_centre(first, g, probe.shape[0])))
        new_s = tree_stack(new_s) if opt_state else ()

        # ---- FedAvg (Eq. 2): the mean over the G cohorts ----
        with torch.no_grad():
            if tcfg.fedavg_compress == "bf16":
                # cohort DELTAS summed in bf16 (cohorts start each round
                # from identical weights, so deltas are small), the mean
                # added back in the parameter's dtype
                base = tree_map(lambda x: x[0], client_params)
                avg = tree_map(
                    lambda b, *ns: b + (torch.stack(
                        [(n - b).to(torch.bfloat16) for n in ns]).sum(0)
                        / len(ns)).to(b.dtype), base, *new_p)
            else:
                avg = tree_map(lambda *xs: torch.stack(xs).mean(0), *new_p)
        del new_p
        metrics = {"loss": torch.stack(losses).mean()}

        if tcfg.split_fl:
            # server aggregation: the selected maps of every cohort
            meta_acts = torch.cat([a for a, _, _, _ in selected])
            meta_tok = torch.cat([t for _, t, _, _ in selected])
            meta_ex = {k: torch.cat([e[k] for _, _, e, _ in selected])
                       for k in extras}
            meta_w = torch.cat([v for _, _, _, v in selected]).to(
                torch.float32)
            del selected
            # meta-train the upper part from the averaged upper
            upper = {"stages": list(avg["stages"][boundary_stage:]),
                     "final_norm": avg["final_norm"]}
            if "lm_head" in avg:
                upper["lm_head"] = avg["lm_head"]
            # the selected maps hold the prefix's positions too
            n_prefix = (cfg.num_prefix_tokens if "prefix_embeds" in extras
                        else 0)

            def upper_loss(up, a_mb, t_mb, w_mb, ex_mb):
                p_view = {"stages": [None] * boundary_stage
                          + list(up["stages"]),
                          "final_norm": up["final_norm"],
                          "embed": avg["embed"]}
                if "lm_head" in up:
                    p_view["lm_head"] = up["lm_head"]
                if cfg.is_encoder_decoder:
                    # the upper half's cross-attention reads the selected
                    # rows' frames through the averaged encoder, which is
                    # not in ``up``: no gradient reaches it here
                    p_view["enc_stages"] = avg["enc_stages"]
                    p_view["enc_norm"] = avg["enc_norm"]
                h, _, aux = lm_split.apply(
                    p_view, None, mode="full", hidden_in=a_mb,
                    stage_range=(boundary_stage, n_stages),
                    return_hidden=True, dtype=dt,
                    enc_frames=ex_mb.get("enc_frames"))
                h = h[:, n_prefix:]
                hn = L.rms_norm(h, up["final_norm"].to(h.dtype),
                                cfg.norm_eps)
                if "lm_head" in up:
                    logits = hn @ up["lm_head"].to(h.dtype)
                else:
                    logits = hn @ avg["embed"].T.to(h.dtype)
                lp = torch.log_softmax(logits[:, :-1].to(torch.float32), -1)
                nll = -torch.gather(lp, -1,
                                    t_mb[:, 1:].long()[..., None])[..., 0]
                per = nll.mean(-1) + aux
                return (per * w_mb).sum() / torch.clamp(w_mb.sum(), min=1.0)

            meta_losses = []
            for _ in range(tcfg.meta_steps):
                loss_m, gm = value_and_grad(upper_loss, upper, meta_acts,
                                            meta_tok, meta_w, meta_ex)
                with torch.no_grad():
                    upper = tree_map(lambda p_, g_: p_ - tcfg.lr * g_,
                                     upper, gm)
                meta_losses.append(loss_m)
            metrics["meta_loss"] = torch.stack(meta_losses).mean()
            metrics["selected"] = meta_w.sum()
            # composed model = [avg lower ; meta-trained upper]
            avg = dict(avg, final_norm=upper["final_norm"],
                       stages=(list(avg["stages"][:boundary_stage])
                               + list(upper["stages"])))
            if "lm_head" in upper:
                avg["lm_head"] = upper["lm_head"]

        # redistribute: next round every cohort starts from W_G(t)
        new_client_params = tree_map(
            lambda x: x[None].expand((g_ax,) + tuple(x.shape)), avg)
        return new_client_params, new_s, metrics

    return train_step, lm_split


# --------------------------------------------------------------------------
# inference steps
# --------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, force_swa: bool = False,
                      dtype=torch.bfloat16):
    """-> (prefill_step(params, batch) -> (B, 1, padded_vocab) logits, lm);
    ``batch`` is a dict with "tokens" (B, S) and, as the model needs them,
    "prefix_embeds" (B, P, d) or "enc_frames" (B, Se, d)."""
    lm = LM(cfg, force_swa=force_swa)

    @torch.no_grad()
    def prefill_step(params, batch):
        extras = {k: batch[k] for k in ("prefix_embeds", "enc_frames")
                  if k in batch}
        h_all, _, _ = lm.apply(params, batch["tokens"], mode="full",
                               return_hidden=True, dtype=dtype, **extras)
        # last-position logits only (vocab projection on one position)
        # as the reference: the norm weight and the head come from the
        # tree as given (f32 master weights give f32 last-position logits)
        h = L.rms_norm(h_all[:, -1:], params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            return h @ params["embed"].T.to(h.dtype)
        return h @ params["lm_head"].to(h.dtype)

    return prefill_step, lm


def make_decode_step(cfg: ModelConfig, force_swa: bool = False,
                     dtype=torch.bfloat16):
    """-> (decode_step(params, cache, tokens (B, 1)) -> (next (B, 1) int32,
    cache), lm)."""
    lm = LM(cfg, force_swa=force_swa)

    @torch.no_grad()
    def decode_step(params, cache, tokens):
        logits, new_cache, _ = lm.apply(params, tokens, mode="decode",
                                        cache=cache, dtype=dtype)
        next_tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        return next_tok, new_cache

    return decode_step, lm
