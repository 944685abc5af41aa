"""Seconds an image spends in the VAE decode (and its copy to the host),
by the pipeline's stage clock, the mean over the window's images."""


def read(m):
    return m.host.get("vae_decode_s")
