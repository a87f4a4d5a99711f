"""Layer: the serving route (``sr_torch.infer.make_serving_predict`` and
what it calls). The host's time to queue one batch's forward: the host
clock around each predict call of the window, with no synchronisation,
averaged over the window's calls. Where it nears the device's time a
batch, the host paces the card."""


def read(ctx):
    enq = ctx.window.get("enqueue_s")
    if not enq:
        return None
    return sum(enq) / len(enq) * 1e3
