from cover_vla_tpu_torch.utils.tree import count_params, cast_tree, param_bytes


def get_class_from_path(dotted: str):
    """'pkg.module.ClassName' -> class object (config-driven adapter /
    evaluator selection, as the reference's pipeline utilities do)."""
    import importlib
    module_path, name = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(module_path), name)
