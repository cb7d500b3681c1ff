from .transformer import Model, build_model, make_rope, make_rope_fn  # noqa: F401
