"""Generated tokens of the requests completed in the window, over the window's whole length."""


def read(run):
    done = [r for r in run.record.requests.values() if run.served_in_window(r)]
    return sum(len(r.obj.generated) for r in done) / run.window_s
