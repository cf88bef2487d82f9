def __getattr__(name):
    # the tree helpers load on first use: `utils.tree` imports the models,
    # and the ops that the models import use `utils.monitor`
    if name in ("count_params", "cast_tree", "param_bytes"):
        from cover_vla_tpu_torch.utils import tree
        return getattr(tree, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_class_from_path(dotted: str):
    """'pkg.module.ClassName' -> class object (config-driven adapter /
    evaluator selection, as the reference's pipeline utilities do)."""
    import importlib
    module_path, name = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(module_path), name)
