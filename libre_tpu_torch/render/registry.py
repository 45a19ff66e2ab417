"""Renderer plugin registry — the RenderPipeline/RendererPlugin pair
(``libre_tpu.render.registry``).

Renderers are registered classes dispatched by name; an unknown name
raises (RenderPipeline.cpp:65-70).  The port registers ``bricked``, the
product default, the exact marcher's ``xla`` and ``pallas-exact``, and
the dense pre-classified ``shearwarp``.
"""

from __future__ import annotations

from typing import Dict, Type

_RENDERERS: Dict[str, Type["RendererPlugin"]] = {}


def register_renderer(name: str):
    def deco(cls: Type["RendererPlugin"]):
        cls.name = name
        _RENDERERS[name] = cls
        return cls

    return deco


def create_renderer(name: str) -> "RendererPlugin":
    """Instantiate a renderer by name (unknown name raises)."""
    try:
        return _RENDERERS[name]()
    except KeyError:
        raise ValueError(
            f"no renderer plugin named {name!r} "
            f"(available: {sorted(_RENDERERS)})"
        ) from None


def available_renderers():
    """The registered renderers' names, sorted."""
    return sorted(_RENDERERS)


class RendererPlugin:
    """Renderer interface: produce an (H, W, 4) frame for a view."""

    name = "?"

    def render(self, engine, camera, frustum, *, params=None, **kwargs):
        raise NotImplementedError


@register_renderer("bricked")
class BrickedRenderer(RendererPlugin):
    """Post-classification sweep over the mixed-LOD rendering set
    streamed through the device brick atlas (the cudaRaycaster
    equivalent, cuda/Renderer.cu:95-230 + TexturePool.cu:101-214)."""

    def render(self, engine, camera, frustum, *, params=None, **kwargs):
        allowed = {
            "screen_space_error", "min_lod", "max_lod", "clip_planes",
            "time_step", "synchronous", "data_range", "n_planes",
        }
        kw = {k: v for k, v in kwargs.items() if k in allowed}
        img, _stats = engine.render_bricked(
            camera, frustum, params=params, **kw
        )
        return img


@register_renderer("shearwarp")
class ShearWarpRenderer(RendererPlugin):
    """Pre-classified shear-warp over a dense LOD level (K5 on the card)."""

    def render(self, engine, camera, frustum, *, params=None, **kwargs):
        allowed = {"level", "time_step", "n_planes", "backend"}
        kw = {k: v for k, v in kwargs.items() if k in allowed}
        return engine.render_shearwarp(camera, params=params, **kw)


# The engine.render keywords ``pallas-exact`` passes on; ``xla`` passes
# every keyword (libre_tpu/render/registry.py:54-114).
_EXACT_KWARGS = {
    "screen_space_error", "min_lod", "max_lod", "clip_planes",
    "time_step", "synchronous", "data_range",
}


@register_renderer("xla")
class XlaRaycastRenderer(RendererPlugin):
    """Exact marcher through the full cache/atlas/multipass engine path
    (the glRaycaster/cudaRaycaster equivalent).  In the port it runs the
    same marcher as ``pallas-exact``: K3 on the card."""

    def render(self, engine, camera, frustum, *, params=None, **kwargs):
        img, _stats, _hist = engine.render(
            camera, frustum, params=params, **kwargs
        )
        return img


@register_renderer("pallas-exact")
class PallasExactRenderer(RendererPlugin):
    """The exact marcher behind the engine's general-camera path: the
    reference's sample grid and ownership rule, K3 on the card."""

    def render(self, engine, camera, frustum, *, params=None, **kwargs):
        kw = {k: v for k, v in kwargs.items() if k in _EXACT_KWARGS}
        img, _stats, _hist = engine.render(
            camera, frustum, params=params, marcher="pallas", **kw
        )
        return img
