"""Each station's settings in a cell: station i takes entry i % len of the
workload's `pattern` over the configuration's own rate, bitrate and mode."""


def station_specs(config, workload):
    pattern = workload.get("pattern") or [{}]
    base = {"rate": config["sample_rate"]}
    base.update((k, config[k]) for k in ("bitrate", "mode") if k in config)
    return [dict(base, **pattern[i % len(pattern)]) for i in range(workload["stations"])]
