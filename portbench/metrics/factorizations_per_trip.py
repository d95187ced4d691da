"""factorizations_per_trip: launches of the Riccati factor kernels
(riccati_cuda's counters) over the loop trips the window ran; nothing where
no factor kernel ran."""


def read(ctx):
    n = (ctx.launches.get("riccati_factor", 0)
         + ctx.launches.get("riccati_factor_gram", 0))
    return n / ctx.trips if n else None
