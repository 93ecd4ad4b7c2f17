"""sweep_config_ms: the window's time, to the end of its last experiment,
over the experiments it completed; a user pays 62 of these a sweep."""


def read(run):
    if not run.records:
        return None
    return (run.window[1] - run.window[0]) / len(run.records) * 1e3
