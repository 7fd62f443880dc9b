"""Device time per step of the kernels launched under the program's
``wgan.critic_update`` spans (critic loss, gradient penalty, Adam), ms."""


def read(t):
    if t["kind"] != "fit":
        return None
    return 1e3 * t["slice"]["span_s"]["wgan.critic_update"] / t["steps"]
