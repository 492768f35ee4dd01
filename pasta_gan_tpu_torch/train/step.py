"""GAN training steps (counterpart of `pasta_gan_tpu/train/step.py`).

Phases of the reference's fashion config, as in the JAX package:

* `train_step`  Gmain, then Dmain on the *updated* G, then G_ema, w_avg and
                the ADA controller;
* `d_r1_step`   Dreg: R1 with the lazy-regularization gain d_reg_interval,
                through the ADA pipe at the state's p;
* `g_pl_step`   Greg: path-length regularization on a `pl_batch_shrink`'d
                batch, with the lazy-regularization gain g_reg_interval;
                the gradient of G's image with respect to ws is taken with
                `create_graph=True`, so the step runs the synthesis
                network's double backward.

The contextual loss (`contextual_weight`) runs in Gmain when a VGG is
loaded, as in the JAX package.  With z_dim > 0, `run_G` draws z and, at
`style_mixing_prob`, mixes a second mapping from a cutoff on; its draws come
from a CPU generator of the trainer (`latent_draws`), so one seed gives the
CPU and the card the same draws.  `unsupported_features` lists what the
trainer refuses.

ADA (train/augment.py) runs in front of every D call when `config.ada` is
enabled, or when an `augment_fn(images, p, generator)` is given (the tests
give a debug-percentile pipe).  Its draws come from one CPU generator of the
trainer, and p is read from the state once per step.  With
`ada.stack_calls` the per-loss D calls run as one call over the stacked
images ([img, ft_img] in Gmain, [img, ft_img, real] in Dmain), ordered by
`_stack_perm` so that every minibatch-std group stays inside one sub-batch
as in the calls one by one; without a pipe the calls run one by one.

Gradients come from `torch.autograd.grad` over one network's parameters, so
the other network accumulates nothing; microbatches (`accum_steps`) add
their gradients and divide by their count.  NaN/Inf gradients are scrubbed
before each Adam update.  Batches are the NHWC dicts of
`data/dataset.py:prepare_train_batch`.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.generator_full import GeneratorFull, cat_feats_dict, nchw
from ..nn.discriminator import Discriminator
from ..runtime.config import TrainConfig, lazy_reg_scaling
from . import losses
from .state import TrainState
from .vgg import VGG19Features, contextual_vgg_loss, vgg_perceptual_loss

Batch = Dict[str, torch.Tensor]


def _scrub(grads: List[torch.Tensor], posinf: float) -> List[torch.Tensor]:
    """NaN/Inf gradient scrubbing (reference `training_loop...py:513-515`)."""
    return [torch.nan_to_num(g, nan=0.0, posinf=posinf, neginf=-posinf) for g in grads]


def unsupported_features(config: TrainConfig) -> List[str]:
    """What `config` asks for that the JAX package does not run either."""
    out = []
    if config.model.freeze_layers:
        out.append("freeze_layers > 0: the JAX Discriminator records which layers are trainable "
                   "(pasta_gan_tpu/nn/discriminator.py:39-49), but no optimizer mask reads it "
                   "(pasta_gan_tpu/nn/layers.py:82-83), so JAX trains every layer")
    if config.loss.pl_weight > 0 and config.model.z_dim > 0:
        out.append("path-length regularization with z_dim > 0: JAX's Greg maps with z=None "
                   "(pasta_gan_tpu/train/step.py:530), which its mapping refuses when z_dim > 0 "
                   "(pasta_gan_tpu/nn/mapping.py:53-54)")
    return out


class GANTrainer:
    """Builds the networks and optimizers of a config and runs its phases."""

    def __init__(self, config: TrainConfig, vgg: Optional[VGG19Features] = None, device="cuda",
                 noise_seed: int = 0, augment_fn: Optional[Callable] = None):
        bad = unsupported_features(config)
        if bad:
            raise ValueError("this training path does not run: " + "; ".join(bad))
        self.config = config
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
        self.vgg = vgg
        self.g_opt_cfg = lazy_reg_scaling(config.g_opt, config.g_reg_interval)
        self.d_opt_cfg = lazy_reg_scaling(config.d_opt, config.d_reg_interval)
        self.noise = torch.Generator(device=self.device).manual_seed(noise_seed)
        if augment_fn is None and config.ada.enabled:
            from .augment import AugmentPipe

            augment_fn = AugmentPipe.from_spec(config.ada.pipe, static_margin=config.ada.static_margin,
                                               fast_geom=config.ada.fast_geom)
        self.augment_fn = augment_fn  # (images NHWC, p, generator) -> images
        self.augment_gen = torch.Generator().manual_seed(noise_seed)  # the pipe's draws, on the host
        # z, the mixing z and the cutoff, on the host (a stream apart from the pipe's)
        latent_seed = int(np.random.SeedSequence((noise_seed, 1)).generate_state(1)[0])
        self.latent_gen = torch.Generator().manual_seed(latent_seed)

    # ------------------------------------------------------------- init

    def build_networks(self) -> Tuple[GeneratorFull, Discriminator]:
        m = self.config.model
        G = GeneratorFull(z_dim=m.z_dim, c_dim=m.c_dim, w_dim=m.w_dim, img_resolution=m.img_resolution,
                          img_channels=m.img_channels, mapping_layers=m.mapping_layers,
                          channel_base=m.channel_base, channel_max=m.channel_max, conv_clamp=m.conv_clamp,
                          use_noise=m.use_noise, style_input_nc=m.style_input_nc, dtype=self.dtype)
        D = Discriminator(c_dim=m.c_dim, img_resolution=m.img_resolution, img_channels=m.img_channels,
                          channel_base=m.channel_base, channel_max=m.channel_max, conv_clamp=m.conv_clamp,
                          mbstd_group_size=m.mbstd_group_size, mbstd_num_channels=m.mbstd_num_channels,
                          dtype=self.dtype)
        return G, D

    def _adam(self, module, opt_cfg) -> torch.optim.Adam:
        return torch.optim.Adam(module.parameters(), lr=opt_cfg.lr, betas=(opt_cfg.beta1, opt_cfg.beta2),
                                eps=opt_cfg.eps)

    def init_state(self, generator: Optional[torch.Generator] = None, G=None, D=None) -> TrainState:
        """A fresh state: G and D drawn from `generator` (or the given modules,
        e.g. weights carried from JAX), G_ema a copy of G."""
        if G is None or D is None:
            G, D = self.build_networks()
            G.reset_parameters(generator)
            D.reset_parameters(generator)
        G = G.to(self.device).set_dtype(self.dtype).train()
        D = D.to(self.device).set_dtype(self.dtype).train()
        G_ema = copy.deepcopy(G).requires_grad_(False).eval()
        f32 = dict(dtype=torch.float32, device=self.device)
        return TrainState(
            step=0, G=G, D=D, G_ema=G_ema,
            g_opt=self._adam(G, self.g_opt_cfg), d_opt=self._adam(D, self.d_opt_cfg),
            w_avg=torch.zeros(self.config.model.w_dim, **f32), pl_mean=torch.zeros((), **f32),
            ada_p=torch.tensor(self.config.ada.initial_p, **f32), ada_signs_sum=torch.zeros((), **f32),
            ada_signs_count=torch.zeros((), **f32),
        )

    # ------------------------------------------------------------- forward helpers

    def latent_draws(self, n: int, num_ws: int) -> Optional[Dict]:
        """run_G's draws for a batch of n, from `latent_gen`: None for z_dim 0;
        else z [n, z_dim] ~ N(0, 1) and, with style_mixing_prob > 0, z2 like
        it, a cutoff in [1, num_ws) and use_mix, true with style_mixing_prob
        (one cutoff and coin for the batch, as in the JAX package)."""
        z_dim, prob = self.config.model.z_dim, self.config.loss.style_mixing_prob
        if z_dim <= 0:
            return None
        g = self.latent_gen
        draws = {"z": torch.randn((n, z_dim), generator=g)}
        if prob > 0:
            draws["z2"] = torch.randn((n, z_dim), generator=g)
            draws["cutoff"] = int(torch.randint(1, num_ws, (), generator=g))
            draws["use_mix"] = bool(torch.rand((), generator=g) < prob)
        return draws

    def run_G(self, G: GeneratorFull, batch: Batch, draws: Optional[Dict] = None):
        """Style/pose encode, map (and, for z_dim > 0, style mixing),
        synthesize (reference run_G).  `draws` (tests) replaces
        `latent_draws`.  Returns (img, finetune_img, pred_parsing) NHWC, ws,
        w_raw and the style code."""
        stylecode, feats = G.encode_style(batch["style_input"], batch["retain"])
        pose_feat = G.encode_pose(batch["pose"])
        if draws is None:
            draws = self.latent_draws(stylecode.shape[0], G.num_ws)
        z = None if draws is None else draws["z"].to(stylecode.device)
        ws, w_raw = G.map_ws(z, stylecode)
        if draws is not None and "z2" in draws and draws["use_mix"]:
            ws2, _ = G.map_ws(draws["z2"].to(stylecode.device), stylecode)
            ws = torch.cat([ws[:, :draws["cutoff"]], ws2[:, draws["cutoff"]:]], dim=1)
        img, ft_img, parsing = G.synthesize(
            ws, pose_feat, cat_feats_dict(feats), batch["denorm_upper_img"], batch["denorm_lower_img"],
            batch["denorm_upper_mask"], batch["denorm_lower_mask"], noise_mode="random", generator=self.noise)
        return img, ft_img, parsing, ws, w_raw, stylecode

    def run_D(self, D: Discriminator, img: torch.Tensor, c: torch.Tensor, p: float = 0.0) -> torch.Tensor:
        """The ADA pipe at probability p, then D, on an NHWC image batch.  The
        pipe runs in the images' own dtype."""
        if self.augment_fn is not None:
            img = self.augment_fn(img, p, self.augment_gen)
        return D(nchw(img), c)

    def _stack_perm(self, n: int, k: int) -> Optional[np.ndarray]:
        """Where sample i of sub-batch j goes in a stacked D call:

            pos(j, i) = j*(n/G) + i mod (n/G) + (i div (n/G)) * k*(n/G)

        MinibatchStdLayer groups strided over the batch (sample q's group is
        {q mod N/G + g*N/G}), so a plain concat would mix gen, finetune and
        real samples in one group; this order keeps each group inside one
        sub-batch and gives the grouping {i, i+n/G, ...} of the calls one by
        one.  None where no such order exists (G None, or n % G != 0)."""
        g = self.config.model.mbstd_group_size
        if g is None or g <= 0 or n % g:
            return None
        npg = n // g
        j = np.arange(k)[:, None]
        i = np.arange(n)[None, :]
        return (j * npg + i % npg + (i // npg) * (k * npg)).reshape(-1)

    def _run_D_multi(self, D: Discriminator, imgs: List[torch.Tensor], c: torch.Tensor, p: float):
        """The pipe and D over several image batches of n samples each: one
        stacked call (`ada.stack_calls`, a pipe, and a `_stack_perm` order),
        else one call per batch.  Returns one logits tensor per batch."""
        n, k = imgs[0].shape[0], len(imgs)
        pos = (self._stack_perm(n, k) if self.config.ada.stack_calls and k > 1 and self.augment_fn is not None
               else None)
        if pos is None:
            return [self.run_D(D, img, c, p) for img in imgs]
        pos_t = torch.from_numpy(pos).to(c.device)
        inv = torch.from_numpy(np.argsort(pos)).to(c.device)  # position q holds stacked sample inv[q]
        stacked = torch.cat(imgs)[inv]  # promotes mixed dtypes, as JAX's concatenate does
        logits = self.run_D(D, stacked, torch.cat([c] * k)[inv], p)[pos_t]
        return list(logits.split(n))

    # ------------------------------------------------------------- losses

    def g_loss_fn(self, G, D, batch: Batch, p: float = 0.0):
        cfg = self.config.loss
        img, ft_img, parsing, _, w_raw, gen_c = self.run_G(G, batch)
        real = batch["real_img"]
        gen_logits, ft_logits = self._run_D_multi(D, [img, ft_img], gen_c, p)
        loss_gan = losses.g_nonsaturating(gen_logits)
        loss_gan_ft = losses.g_nonsaturating(ft_logits)
        loss_l1 = losses.l1_loss(img, real) * cfg.l1_weight
        loss_l1_ft = losses.l1_loss(ft_img, real) * cfg.l1_weight
        zero = real.new_zeros(())
        loss_mask = zero
        if cfg.mask_weight > 0:
            loss_mask = losses.parsing_cross_entropy(parsing, batch["gt_parsing"]) * cfg.mask_weight
        loss_vgg = loss_vgg_ft = zero
        if cfg.vgg_weight > 0 and self.vgg is not None:
            with torch.no_grad():
                real_feats = self.vgg(real)
            loss_vgg = vgg_perceptual_loss(self.vgg, img, y_feats=real_feats) * cfg.vgg_weight
            loss_vgg_ft = vgg_perceptual_loss(self.vgg, ft_img, y_feats=real_feats) * cfg.vgg_weight
        loss_ctx = zero
        if cfg.contextual_weight > 0 and self.vgg is not None:
            loss_ctx = contextual_vgg_loss(self.vgg, ft_img, real) * cfg.contextual_weight
        total = ((loss_gan + loss_gan_ft) / 2 + (loss_l1 + loss_l1_ft) / 2 + (loss_vgg + loss_vgg_ft) / 2
                 + loss_mask + loss_ctx)
        stats = {
            "Loss/G/loss": loss_gan, "Loss/G/loss_finetune": loss_gan_ft,
            "Loss/G/L1": loss_l1, "Loss/G/L1_finetune": loss_l1_ft,
            "Loss/G/vgg": loss_vgg, "Loss/G/vgg_finetune": loss_vgg_ft,
            "Loss/G/mask_loss": loss_mask, "Loss/G/contextual": loss_ctx,
            "Loss/scores/fake": gen_logits.mean(), "Loss/signs/fake": gen_logits.sign().mean(),
            "w_mean": w_raw.float().mean(dim=0),
        }
        return total, stats

    def d_loss_fn(self, D, G, batch: Batch, p: float = 0.0):
        with torch.no_grad():
            img, ft_img, _, _, _, gen_c = self.run_G(G, batch)
        gen_logits, ft_logits, real_logits = self._run_D_multi(D, [img, ft_img, batch["real_img"]], gen_c, p)
        loss_dgen = (losses.d_fake(gen_logits) + losses.d_fake(ft_logits)) / 2
        loss_dreal = losses.d_real(real_logits)
        total = loss_dgen + loss_dreal
        stats = {"Loss/D/loss": total, "Loss/scores/real": real_logits.mean(),
                 "Loss/signs/real": real_logits.sign().mean()}
        return total, stats

    # ------------------------------------------------------------- steps

    def _grads_with_accum(self, loss_fn: Callable[[Batch], Tuple[torch.Tensor, Dict]], params, batch: Batch):
        """Gradients of loss_fn over `params`, averaged over `accum_steps`
        microbatches (reference grad-accumulation rounds), and the stats,
        averaged the same way (detached)."""
        A = max(1, self.config.accum_steps)
        n = next(iter(batch.values())).shape[0]
        if n % A:
            raise ValueError(f"accum_steps {A} must divide the batch {n}")
        grads = [torch.zeros_like(p) for p in params]
        stats: Dict[str, torch.Tensor] = {}
        for i in range(A):
            mb = {k: v[i * n // A : (i + 1) * n // A] for k, v in batch.items()}
            loss, aux = loss_fn(mb)
            gs = torch.autograd.grad(loss, params, allow_unused=True)
            for acc, g in zip(grads, gs):
                if g is not None:
                    acc.add_(g)
            for k, v in aux.items():
                v = v.detach().float()
                stats[k] = stats[k] + v if k in stats else v
        return [g / A for g in grads], {k: v / A for k, v in stats.items()}

    def _apply(self, opt: torch.optim.Optimizer, params, grads) -> None:
        for p, g in zip(params, _scrub(grads, self.config.grad_clip_posinf)):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def train_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Gmain, Dmain on the updated G, G_ema, w_avg and the ADA controller; in place."""
        cfg = self.config
        p = float(state.ada_p)  # both phases augment at the step's starting p
        g_params = list(state.G.parameters())
        g_grads, g_stats = self._grads_with_accum(lambda b: self.g_loss_fn(state.G, state.D, b, p), g_params, batch)
        self._apply(state.g_opt, g_params, g_grads)

        d_params = list(state.D.parameters())
        d_grads, d_stats = self._grads_with_accum(lambda b: self.d_loss_fn(state.D, state.G, b, p), d_params, batch)
        self._apply(state.d_opt, d_params, d_grads)

        with torch.no_grad():
            # G_ema (training_loop...py:521-529): p + beta (ema - p)
            cur_nimg = (state.step + 1) * cfg.batch_size
            ema_nimg = cfg.ema_kimg * 1000.0
            if cfg.ema_rampup is not None:
                ema_nimg = min(ema_nimg, cur_nimg * cfg.ema_rampup)
            beta = 0.5 ** (cfg.batch_size / max(ema_nimg, 1e-8))
            for p, e in zip(state.G.parameters(), state.G_ema.parameters()):
                e.copy_(p + beta * (e - p))
            w_mean = g_stats.pop("w_mean")
            state.w_avg.copy_(w_mean + cfg.w_avg_beta * (state.w_avg - w_mean))
            state.ada_signs_sum.add_(d_stats["Loss/signs/real"])
            state.ada_signs_count.add_(1.0)
            if cfg.ada.enabled and (state.step + 1) % cfg.ada.interval == 0:
                # ADA controller (training_loop...py:536-539)
                mean_sign = state.ada_signs_sum / state.ada_signs_count.clamp_min(1.0)
                adjust = torch.sign(mean_sign - cfg.ada.target) * (
                    (cfg.batch_size * cfg.ada.interval) / (cfg.ada.kimg * 1000.0))
                state.ada_p.copy_((state.ada_p + adjust).clamp_min(0.0))
                state.ada_signs_sum.zero_()
                state.ada_signs_count.zero_()
        state.step += 1
        stats = {**g_stats, **d_stats, "Progress/augment_p": state.ada_p.clone()}
        return state, stats

    def d_r1_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Dreg: R1 on the real images, through the pipe at the state's p, with
        the lazy-regularization gain; in place."""
        cfg = self.config
        gain = float(cfg.d_reg_interval or 1)
        scale = cfg.loss.r1_gamma / 2.0 * gain
        p = float(state.ada_p)

        def r1_loss(b):
            with torch.no_grad():  # conditioning from the style encoder; Dreg does not touch G
                gen_c, _ = state.G.encode_style(b["style_input"], b["retain"])
            penalty = losses.r1_penalty(lambda x: self.run_D(state.D, x, gen_c, p), b["real_img"])
            return penalty * scale, {"Loss/r1_penalty": penalty}

        d_params = list(state.D.parameters())
        d_grads, stats = self._grads_with_accum(r1_loss, d_params, batch)
        self._apply(state.d_opt, d_params, d_grads)
        stats["Loss/D/reg"] = stats["Loss/r1_penalty"] * scale
        return state, stats

    def g_pl_step(self, state: TrainState, batch: Batch,
                  pl_noise: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Greg: path-length regularization on the first max(1, n //
        pl_batch_shrink) samples, with the lazy-regularization gain; in
        place.  `pl_noise` (tests) replaces the draw N(0, 1) / sqrt(H W) of
        the image's shape."""
        cfg = self.config
        shrink = max(1, cfg.loss.pl_batch_shrink)
        small = {k: v[: max(1, v.shape[0] // shrink)] for k, v in batch.items()}
        gain = float(cfg.g_reg_interval or 1)
        G = state.G
        stylecode, feats = G.encode_style(small["style_input"], small["retain"])
        pose_feat = G.encode_pose(small["pose"])
        ws, _ = G.map_ws(None, stylecode)
        img, _, _ = G.synthesize(
            ws, pose_feat, cat_feats_dict(feats), small["denorm_upper_img"], small["denorm_lower_img"],
            small["denorm_upper_mask"], small["denorm_lower_mask"], noise_mode="random", generator=self.noise)
        if pl_noise is None:
            pl_noise = torch.randn(img.shape, generator=self.noise, device=img.device) / math.sqrt(
                img.shape[1] * img.shape[2])
        (pl_grads,) = torch.autograd.grad((img.float() * pl_noise).sum(), ws, create_graph=True)
        penalty, new_mean = losses.pl_penalty_from_grads(pl_grads, state.pl_mean, cfg.loss.pl_decay)
        loss = penalty * cfg.loss.pl_weight * gain
        g_params = list(G.parameters())
        grads = torch.autograd.grad(loss, g_params, allow_unused=True)
        # a parameter the image does not reach (the finetune and parsing heads) takes
        # a zero gradient, so Adam's moments decay as they do in the JAX step
        self._apply(state.g_opt, g_params, [torch.zeros_like(p) if g is None else g for g, p in zip(grads, g_params)])
        state.pl_mean.copy_(new_mean.detach())
        return state, {"Loss/pl_penalty": penalty.detach(), "Loss/G/reg": loss.detach()}
