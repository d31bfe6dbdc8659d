"""The 80 OpenAI ImageNet prompt templates (public data constants from the
OpenAI CLIP release), a copy of ``vit_prisma_tpu/utils/openai_templates.py``
held equal to it by ``tests/test_torch_zero_shot.py``.  Stored as format
strings; use :func:`apply_template`."""

OPENAI_IMAGENET_TEMPLATE_STRINGS = (
    "a bad photo of a {c}.", "a photo of many {c}.", "a sculpture of a {c}.",
    "a photo of the hard to see {c}.", "a low resolution photo of the {c}.",
    "a rendering of a {c}.", "graffiti of a {c}.", "a bad photo of the {c}.",
    "a cropped photo of the {c}.", "a tattoo of a {c}.",
    "the embroidered {c}.", "a photo of a hard to see {c}.",
    "a bright photo of a {c}.", "a photo of a clean {c}.",
    "a photo of a dirty {c}.", "a dark photo of the {c}.",
    "a drawing of a {c}.", "a photo of my {c}.", "the plastic {c}.",
    "a photo of the cool {c}.", "a close-up photo of a {c}.",
    "a black and white photo of the {c}.", "a painting of the {c}.",
    "a painting of a {c}.", "a pixelated photo of the {c}.",
    "a sculpture of the {c}.", "a bright photo of the {c}.",
    "a cropped photo of a {c}.", "a plastic {c}.",
    "a photo of the dirty {c}.", "a jpeg corrupted photo of a {c}.",
    "a blurry photo of the {c}.", "a photo of the {c}.",
    "a good photo of the {c}.", "a rendering of the {c}.",
    "a {c} in a video game.", "a photo of one {c}.", "a doodle of a {c}.",
    "a close-up photo of the {c}.", "a photo of a {c}.",
    "the origami {c}.", "the {c} in a video game.", "a sketch of a {c}.",
    "a doodle of the {c}.", "a origami {c}.",
    "a low resolution photo of a {c}.", "the toy {c}.",
    "a rendition of the {c}.", "a photo of the clean {c}.",
    "a photo of a large {c}.", "a rendition of a {c}.",
    "a photo of a nice {c}.", "a photo of a weird {c}.",
    "a blurry photo of a {c}.", "a cartoon {c}.", "art of a {c}.",
    "a sketch of the {c}.", "a embroidered {c}.",
    "a pixelated photo of a {c}.", "itap of the {c}.",
    "a jpeg corrupted photo of the {c}.", "a good photo of a {c}.",
    "a plushie {c}.", "a photo of the nice {c}.",
    "a photo of the small {c}.", "a photo of the weird {c}.",
    "the cartoon {c}.", "art of the {c}.", "a drawing of the {c}.",
    "a photo of the large {c}.", "a black and white photo of a {c}.",
    "the plushie {c}.", "a dark photo of a {c}.", "itap of a {c}.",
    "graffiti of the {c}.", "a toy {c}.", "itap of my {c}.",
    "a photo of a cool {c}.", "a photo of a small {c}.",
    "a tattoo of the {c}.",
)

# Callable form, as the JAX package's.
OPENAI_IMAGENET_TEMPLATES = tuple(
    (lambda t: (lambda c: t.format(c=c)))(t)
    for t in OPENAI_IMAGENET_TEMPLATE_STRINGS
)


def apply_template(template: str, classname: str) -> str:
    return template.format(c=classname)
