"""Streamlit GUI over the port's pipeline on the card: txt2img / img2img / inpaint
tabs (the counterpart of the reference ``app.py``: cached pipeline rebuilt on a
size change, size sliders, seed box, negative prompt, LPW syntax, PNG and prompt
saving).

Run: ``streamlit run minsdtf_tpu_torch/apps/app.py`` (streamlit is not installed
with the package; install it where the app is served). Importing the module does
not need streamlit.
"""

from __future__ import annotations

import numpy as np

try:
    import streamlit as st
except ImportError:
    st = None

from minsdtf_tpu_torch.apps import common


SAMPLERS = ["ddim", "dpm", "dpm_karras", "euler_a", "tcd", "lcm"]


def pipeline(height: int, width: int, sampler: str = "ddim"):
    return common.build_pipeline(height, width, scheduler_type=sampler)


if st is not None:  # one pipeline per (size, sampler), kept across reruns
    pipeline = st.cache_resource(pipeline)


def controls(tab, with_image=False, with_mask=False):
    prompt = tab.text_area("Prompt (A1111 weighting supported)", "a photo of an astronaut riding a horse")
    negative = tab.text_area("Negative prompt", "")
    col1, col2, col3 = tab.columns(3)
    height = col1.select_slider("Height", options=list(range(128, 2049, 64)), value=512)
    width = col1.select_slider("Width", options=list(range(128, 2049, 64)), value=512)
    steps = col2.slider("Steps", 1, 100, 25)
    sampler = col2.selectbox("Sampler", SAMPLERS, index=0)
    scale = col2.slider("Guidance scale", 0.0, 20.0, 7.5)
    rescale = col3.slider("Guidance rescale", 0.0, 1.0, 0.7)
    seed = col3.number_input("Seed", value=int(np.random.randint(0, 2**31 - 1)))
    batch = col3.slider("Images", 1, 8, 1)
    image = tab.file_uploader("Reference image") if with_image else None
    strength = tab.slider("Strength", 0.0, 1.0, 0.8) if with_image else None
    mask = None
    blur = None
    if with_mask:
        blur = tab.slider("Mask blur", 1, 33, 5, step=2)
        mask = tab.file_uploader("Inpaint mask (white = regenerate)")
        if mask is None and image is not None:
            # Freehand mask like the reference app (app.py:263-281); optional dep.
            try:
                from PIL import Image
                from streamlit_drawable_canvas import st_canvas

                bg = Image.open(image).convert("RGB")
                canvas = st_canvas(
                    fill_color="rgba(255,255,255,1)", stroke_width=24,
                    stroke_color="rgba(255,255,255,1)", background_image=bg,
                    width=min(width, 768), height=min(height, 768), key=f"canvas-{tab}",
                )
                if canvas.image_data is not None:
                    alpha = np.asarray(canvas.image_data)[..., 3]
                    mask = (alpha > 0).astype(np.uint8) * 255
            except ImportError:
                tab.caption("install streamlit-drawable-canvas for freehand masks")
    return dict(prompt=prompt, negative=negative, height=height, width=width,
                steps=steps, sampler=sampler, scale=scale, rescale=rescale,
                seed=int(seed), batch=batch, image=image, strength=strength,
                mask=mask, blur=blur)


def run(kind: str, cfg: dict):
    pipe = pipeline(cfg["height"], cfg["width"], cfg.get("sampler", "ddim"))
    progress = st.progress(0.0)
    callback = lambda i: progress.progress(min(1.0, i / max(1, cfg["steps"])))
    kw = dict(
        prompt=cfg["prompt"], negative_prompt=cfg["negative"] or None,
        batch_size=cfg["batch"], num_steps=cfg["steps"],
        unconditional_guidance_scale=cfg["scale"], guidance_rescale=cfg["rescale"],
        seed=cfg["seed"], callback=callback,
    )
    if kind == "txt2img":
        images = pipe.text_to_image(**kw)
    else:
        from PIL import Image

        ref = np.array(Image.open(cfg["image"]).convert("RGB"))
        kw.update(reference_image=ref, reference_image_strength=cfg["strength"])
        if kind == "img2img":
            images = pipe.image_to_image(**kw)
        else:
            mask = cfg["mask"]
            if not isinstance(mask, np.ndarray):
                mask = np.array(Image.open(mask).convert("L"))
            kw.update(inpaint_mask=mask, mask_blur_strength=cfg["blur"])
            images = pipe.inpaint(**kw)
    common.save_outputs(images, cfg["prompt"])
    for img in images:
        st.image(img)


def main():
    if st is None:
        raise SystemExit("streamlit is not installed in this environment")
    st.title("minsdtf-tpu — Stable Diffusion in PyTorch on the card")
    t1, t2, t3 = st.tabs(["Text to Image", "Image to Image", "Inpaint"])
    with t1:
        cfg = controls(t1)
        if st.button("Generate", key="t2i"):
            run("txt2img", cfg)
    with t2:
        cfg = controls(t2, with_image=True)
        if st.button("Generate", key="i2i") and cfg["image"]:
            run("img2img", cfg)
    with t3:
        cfg = controls(t3, with_image=True, with_mask=True)
        if st.button("Generate", key="inp") and cfg["image"] and cfg["mask"]:
            run("inpaint", cfg)


if __name__ == "__main__":
    main()
