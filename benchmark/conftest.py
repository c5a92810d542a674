"""What the benchmark's CPU tests need to know of the cells and metrics that
their own tables do not list: the toy sizes of ``tests/conftest.py``'s
``TINY_CONFIGS`` and ``TINY_TRAFFIC`` (its ``tiny`` fixture cuts every cell
to them) and the per-layer metrics that read only on a card (a test
module's ``CARD_ONLY``). Each table is extended when pytest registers the
conftest module or collects the test module that holds it."""

EXTEND = {
    "TINY_CONFIGS": {"hrc_impute": {"haplotypes": 600, "sites": 2048}},
    "TINY_TRAFFIC": {"gwas_t2000": {"targets": 24, "pool_batches": 2,
                                    "sampled_targets": 4, "kept_results": 2}},
    # K5's kernels and the card's idle share are in a card's trace alone
    "CARD_ONLY": {"k5_impute_vote.roofline_pct", "device_idle_pct.impute"},
}


def _extend(module) -> None:
    for name, more in EXTEND.items():
        table = getattr(module, name, None)
        if isinstance(table, dict) and table is not more:
            for key, value in more.items():
                table.setdefault(key, value)
        elif isinstance(table, set):
            table |= more


def pytest_plugin_registered(plugin, manager):
    _extend(plugin)


def pytest_collection_modifyitems(session, config, items):
    for module in {getattr(item, "module", None) for item in items}:
        _extend(module)
