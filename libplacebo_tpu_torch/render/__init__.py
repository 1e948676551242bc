"""Frames and the renderer."""

from .mpv_hooks import parse_user_shader, user_shader_hook  # noqa: F401
