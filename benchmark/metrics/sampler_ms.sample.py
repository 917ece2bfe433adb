"""sampler_ms.sample: the sampler's own device ms a DDIM step (the clamp,
pred_noise, the draw, the trajectory clamp, the harness's recorder
copies): sample.step less its sample.guided, from the port's spans."""

from benchmark.spans import sampler_ms as read  # noqa: F401
