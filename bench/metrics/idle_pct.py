"""The device's idle share of the traced window (the train cells' chunks or
the score cell's batches): the share in which no kernel, copy or fill ran
on the device, in percent."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100
