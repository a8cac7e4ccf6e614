"""Encoder-family registry: the pluggable seam of the GBATC codec core.

The paper's pipeline is architecture-agnostic by construction — the
guarantee engine bounds *whatever* reconstruction the decoder produces —
so the codec core dispatches every model-shaped decision through this
registry instead of hard-wiring the conv block autoencoder. Each
:class:`EncoderFamily` owns:

* its **wire identity** — a one-byte family tag carried in the container
  v5 ``meta`` stream (below v5 the family is implicitly ``"conv"``);
* its **arch words** — the family-specific u16 fields riding in the meta
  stream's arch slot (conv: the conv channel widths; attention:
  ``(d_model, n_heads, depth, mlp_hidden)``) plus their validation;
* **model construction** from a :class:`StructuralConfig` (everything
  the decode side needs travels in the blob — no ambient pipeline
  state), the training entry point, the decode-side parameter defs, and
  the fused-decode factory.

:class:`StructuralConfig` is the family-owned structural config the
decode path runs on: :func:`structural` normalizes any config-shaped
object (a ``PipelineConfig``, an artifact's unpacked config, another
``StructuralConfig``) into it, so ``runtime._runtime`` keys and builds
decode runtimes from blob-derivable facts alone — two families sharing
geometry/latent can never alias a runtime (the family name is part of
the key and of the config's equality).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Optional

if TYPE_CHECKING:  # annotation-only: the core package's __init__ imports
    from repro_torch.core import blocking  # the pipeline, which imports us


# ---------------------------------------------------------------------------
# family-owned structural config (what the decode path runs on)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StructuralConfig:
    """Structure the blob alone determines: enough to rebuild the decode
    runtime, nothing more (no training hyperparameters, no ambient
    state). ``arch`` is the family's wire arch tuple."""

    family: str
    geometry: blocking.BlockGeometry
    latent: int
    arch: tuple[int, ...]
    use_correction: bool
    param_dtype_bytes: int

    @property
    def conv_channels(self) -> tuple[int, ...]:
        """Conv-family alias for ``arch`` (the historical field name;
        artifact consumers read ``artifact.cfg.conv_channels``)."""
        return self.arch


def structural(cfg: Any) -> StructuralConfig:
    """Normalize any config-shaped object into a :class:`StructuralConfig`.

    Duck-typed: accepts a ``StructuralConfig`` (returned as-is), a
    ``repro_torch.core.pipeline.PipelineConfig`` (its optional ``family`` /
    ``arch`` fields resolve through the registry; a conv config's arch
    defaults to its ``conv_channels``), or anything exposing the same
    attributes. The result is the *identity* the runtime cache keys on.
    """
    if isinstance(cfg, StructuralConfig):
        return cfg
    fam = get(getattr(cfg, "family", None) or "conv")
    return StructuralConfig(
        family=fam.name,
        geometry=cfg.geometry,
        latent=int(cfg.latent),
        arch=fam.arch_of(cfg),
        use_correction=bool(cfg.use_correction),
        param_dtype_bytes=int(cfg.param_dtype_bytes),
    )


# ---------------------------------------------------------------------------
# fused decode factory (shared across families; families may override)
# ---------------------------------------------------------------------------
def make_fused_decode(model, corr_net):
    """Latents -> corrected (S, NB, D) block vectors, as one function.

    The whole NN decode — family decoder, pointwise tensor correction, and
    the blocks->vectors layout change — over device tensors, shared by the
    encode side (the reconstruction the guarantee is computed against) and
    the decode side (the one ``decompress`` replays), so both see the same
    kernels on the same shapes. All reshuffles are pure transposes.
    ``dec_params`` / ``corr_params`` are flat ``state_dict``-style dicts
    (see :mod:`repro_torch.convert`). Any model exposing ``cfg.n_species``
    and ``decode(z, params) -> (NB, S, bt, ph, pw)`` composes.
    """
    s = model.cfg.n_species

    def fused(dec_params, corr_params, lat):
        x = model.decode(lat, dec_params)  # (NB, S, bt, ph, pw)
        nb = x.shape[0]
        if corr_net is not None:
            vec = x.reshape(nb, s, -1).permute(0, 2, 1).reshape(-1, s)
            vec = corr_net(vec, corr_params)
            x = vec.reshape(nb, -1, s).permute(0, 2, 1).reshape(x.shape)
        return x.reshape(nb, s, -1).permute(1, 0, 2).contiguous()  # (S, NB, D)

    return fused


def _decoder_defs(model) -> dict:
    """Decode-side parameter defs: the ``dec``-prefixed subtree, the
    single source for what travels in the ``decoder`` stream."""
    return {k: v for k, v in model.defs.items() if k.startswith("dec")}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EncoderFamily:
    """One pluggable encoder/decoder family.

    ``tag`` is the family's wire identity (container v5 meta stream; 0 is
    reserved as invalid). ``arch_of`` extracts the family's arch words
    from a config-shaped object; ``validate_arch`` returns an error
    string for arch words that cannot configure a model (the wire layer
    turns it into a ``ContainerFormatError`` with meta coordinates).
    """

    name: str
    tag: int
    build_model: Callable[..., Any]  # (scfg, n_species, device) -> model
    fit: Callable[..., tuple]
    arch_of: Callable[[Any], tuple]
    validate_arch: Callable[[tuple], Optional[str]]
    decoder_defs: Callable[[Any], dict] = _decoder_defs
    make_fused: Callable[[Any, Any], Any] = make_fused_decode


def _conv_build(scfg: StructuralConfig, n_species: int, device=None):
    from repro_torch.core import autoencoder as ae

    geom = scfg.geometry
    return ae.BlockAutoencoder(ae.AEConfig(
        n_species=n_species,
        block=(geom.bt, geom.ph, geom.pw),
        latent=scfg.latent,
        conv_channels=scfg.arch,
    ), device=device)


def _conv_fit(model, blocks, **kw):
    from repro_torch.core import autoencoder as ae

    return ae.fit(model, blocks, **kw)


def _conv_arch_of(cfg: Any) -> tuple:
    arch = getattr(cfg, "arch", None)
    if arch is None:
        arch = cfg.conv_channels
    return tuple(int(c) for c in arch)


def _conv_validate(arch: tuple) -> Optional[str]:
    return None  # any positive widths configure a conv stack


#: default attention arch words (d_model, n_heads, depth, mlp_hidden) —
#: the reference's; override via ``PipelineConfig(family="attention", arch=...)``
DEFAULT_ATTENTION_ARCH = (32, 2, 1, 64)


def _attention_build(scfg: StructuralConfig, n_species: int, device=None):
    """The attention model the codec runs: every forward pass it makes
    without gradients (latents, the fused decode on both sides) goes
    through the flash kernel on a CUDA device."""
    from repro_torch.models import block_attention as ba

    geom = scfg.geometry
    dm, nh, depth, mlp = scfg.arch
    return ba.BlockAttentionAE(ba.BlockAttentionConfig(
        n_species=n_species,
        block=(geom.bt, geom.ph, geom.pw),
        latent=scfg.latent,
        d_model=dm, n_heads=nh, depth=depth, mlp_hidden=mlp,
        attn_impl="flash",
    ), device=device)


def _attention_fit(model, blocks, **kw):
    """Trains through the direct attention on the same parameters (the
    kernel has no backward; the reference's fit never selects flash)."""
    from repro_torch.models import block_attention as ba

    return ba.fit(model, blocks, **kw)


def _attention_arch_of(cfg: Any) -> tuple:
    arch = getattr(cfg, "arch", None)
    if arch is None:
        arch = DEFAULT_ATTENTION_ARCH
    arch = tuple(int(c) for c in arch)
    err = _attention_validate(arch)
    if err:
        raise ValueError(f"bad attention arch {arch}: {err}")
    return arch


def _attention_validate(arch: tuple) -> Optional[str]:
    if len(arch) != 4:
        return (f"attention arch carries {len(arch)} words, expected 4 "
                f"(d_model, n_heads, depth, mlp_hidden)")
    dm, nh, _, _ = arch
    if dm % nh:
        return f"d_model {dm} not divisible by n_heads {nh}"
    return None


CONV = EncoderFamily(
    name="conv", tag=1,
    build_model=_conv_build, fit=_conv_fit,
    arch_of=_conv_arch_of, validate_arch=_conv_validate,
)
ATTENTION = EncoderFamily(
    name="attention", tag=2,
    build_model=_attention_build, fit=_attention_fit,
    arch_of=_attention_arch_of, validate_arch=_attention_validate,
)

FAMILIES: dict[str, EncoderFamily] = {f.name: f for f in (CONV, ATTENTION)}
_BY_TAG: dict[int, EncoderFamily] = {f.tag: f for f in FAMILIES.values()}
assert len(_BY_TAG) == len(FAMILIES) and 0 not in _BY_TAG, \
    "family tags must be unique and nonzero"


def get(name: str) -> EncoderFamily:
    """Family handle by name; raises ``ValueError`` on unknown names
    (caller-supplied config — not wire data, which goes via ``by_tag``)."""
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown encoder family {name!r} "
            f"(registered: {sorted(FAMILIES)})"
        ) from None


def by_tag(tag: int) -> Optional[EncoderFamily]:
    """Family handle by wire tag, ``None`` when unregistered — the wire
    layer raises the structured ``ContainerFormatError``."""
    return _BY_TAG.get(tag)


def registered() -> tuple[tuple[str, int], ...]:
    """(name, tag) pairs, sorted by tag — what the wire-schema
    conformance pass cross-checks its declarative family table against."""
    return tuple(sorted(((f.name, f.tag) for f in FAMILIES.values()),
                        key=lambda p: p[1]))
