"""Web UI layer: the dependency-free browser UI served at ``/ui``, and the
Gradio UI.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/serving/webui.py``:

- ``INDEX_HTML`` (webcam / upload / composite tabs, client-side 512² center
  crop, steps slider, CFG toggle, blend ratio, the websocket stream), a
  copy of that page;
- :func:`create_ui`, the Gradio Blocks UI with the same tabs, defaults and
  callbacks; ``gradio`` is imported when it is called, and its absence
  raises an ``ImportError`` that points to ``/ui``. Images stay arrays: the
  resize and the composite run through ``core/imaging.py``, never PIL.

Gradio UI on the card (where gradio is installed)::

    python -m qwen_image_edit_streamdiffusion_tpu_torch.serving.webui
"""

from __future__ import annotations

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Qwen Image Edit (GPU)</title>
<style>
 body{font-family:system-ui;margin:2em auto;max-width:1100px;color:#222}
 .row{display:flex;gap:1em;flex-wrap:wrap}
 .col{flex:1;min-width:320px}
 img,video,canvas{max-width:512px;width:100%;border:1px solid #ccc;border-radius:8px}
 button{padding:.5em 1.2em;margin:.3em .3em .3em 0;border-radius:6px;border:1px solid #888;cursor:pointer}
 button.active{background:#334;color:#fff}
 textarea{width:100%;min-height:3em}
 label{display:block;margin:.4em 0}
 #status{color:#666;margin:.5em 0}
</style></head><body>
<h2>Qwen-Image-Edit-2509 — GPU realtime editing</h2>
<div>
 <button id="tab-webcam" class="active">Webcam</button>
 <button id="tab-upload">Upload</button>
 <button id="tab-composite">Composite</button>
</div>
<div class="row">
 <div class="col">
  <video id="video" autoplay playsinline style="display:block"></video>
  <input type="file" id="file" accept="image/*" style="display:none">
  <input type="file" id="reffile" accept="image/*" style="display:none">
  <canvas id="canvas" style="display:none"></canvas>
  <textarea id="prompt">Transform into oil painting style</textarea>
  <label>Steps: <input type="range" id="steps" min="2" max="8" step="1" value="2">
    <span id="stepsv">2</span></label>
  <label><input type="checkbox" id="cfg"> CFG (higher quality, slower)</label>
  <label id="streamrow"><input type="checkbox" id="stream"> Stream webcam
    (temporal session: keyframes re-anchor, in-between frames refine-only)</label>
  <label id="wsrow"><input type="checkbox" id="wst" checked> Binary WebSocket
    transport (raw JPEG both ways, full-duplex; unchecked = HTTP POSTs)</label>
  <label id="blendrow" style="display:none">Blend:
    <input type="range" id="blend" min="0" max="1" step="0.05" value="0.5"></label>
  <button id="go">Edit</button>
  <div id="status">idle</div>
 </div>
 <div class="col"><img id="result" alt="result appears here"></div>
</div>
<script>
let mode='webcam', refData=null, busy=false;
const $=id=>document.getElementById(id);
const tabs={'webcam':$('tab-webcam'),'upload':$('tab-upload'),'composite':$('tab-composite')};
function setMode(m){mode=m;for(const k in tabs)tabs[k].classList.toggle('active',k===m);
 $('video').style.display=m==='webcam'?'block':'none';
 $('file').style.display=m!=='webcam'?'block':'none';
 $('reffile').style.display=m==='composite'?'block':'none';
 $('blendrow').style.display=m==='composite'?'block':'none';
 $('streamrow').style.display=m==='webcam'?'block':'none';
 $('wsrow').style.display=m==='webcam'?'block':'none';
 if(m!=='webcam'){$('stream').checked=false;wsStop();}}
for(const k in tabs)tabs[k].onclick=()=>setMode(k);
$('steps').oninput=e=>$('stepsv').textContent=e.target.value;
navigator.mediaDevices.getUserMedia({video:true}).then(s=>$('video').srcObject=s).catch(()=>{});
function drawCrop(src,w,h){const c=$('canvas');c.width=512;c.height=512;
 const s=Math.min(w,h);c.getContext('2d').drawImage(src,(w-s)/2,(h-s)/2,s,s,0,0,512,512);
 return c;}
function crop512(src,w,h){return drawCrop(src,w,h).toDataURL('image/jpeg',0.9);}
function fileToData(f,cb){const img=new Image();img.onload=()=>cb(crop512(img,img.width,img.height));
 img.src=URL.createObjectURL(f);}
$('reffile').onchange=e=>{if(e.target.files[0])fileToData(e.target.files[0],d=>refData=d);};
function send(data,extra,onDone,onFail){
 busy=true;if(!extra)$('status').textContent='processing...';const t0=Date.now();
 const body={image:data,prompt:$('prompt').value,steps:+$('steps').value,
             use_cfg:$('cfg').checked,...(extra||{})};
 if(mode==='composite'&&refData){body.ref_image=refData;body.blend_ratio=+$('blend').value;}
 fetch('/edit',{method:'POST',headers:{'Content-Type':'application/json'},
   body:JSON.stringify(body)})
  .then(r=>r.json().then(j=>({ok:r.ok,code:r.status,j})))
  .then(({ok,code,j})=>{busy=false;
    if(!ok){$('status').textContent='error '+code+': '+(j.detail||'');
     if(onFail)onFail();return;}
    $('result').src='data:image/jpeg;base64,'+j.image;
    if(onDone){onDone(j);}
    else $('status').textContent='done in '+j.elapsed.toFixed(2)+'s (round trip '+((Date.now()-t0)/1000).toFixed(2)+'s)';})
  .catch(e=>{busy=false;$('status').textContent='error: '+e;
   if(onFail)onFail();});
}
$('go').onclick=()=>{
 if(busy)return;
 if(mode==='webcam'){const v=$('video');send(crop512(v,v.videoWidth,v.videoHeight));}
 else{const f=$('file').files[0];if(!f){$('status').textContent='pick a file';return;}
  fileToData(f,d=>send(d));}
};
// Stream mode: POST frames continuously under ONE stream_session id —
// the server keeps temporal latent state (keyframes re-anchor, frames in
// between re-noise the previous latent and run refine-only).
let streamSid=null,streamN=0,streamT0=0;
function streamTick(){
 if(!$('stream').checked||mode!=='webcam')return;
 if(busy){setTimeout(streamTick,30);return;}
 const v=$('video');
 send(crop512(v,v.videoWidth,v.videoHeight),
  {stream_session:streamSid,stream_pipeline:true},j=>{
  streamN++;const fps=streamN/((Date.now()-streamT0)/1000);
  $('status').textContent='streaming '+fps.toFixed(1)+' fps (frame '+streamN+
    (j.keyframe?', keyframe':'')+')';
  setTimeout(streamTick,0);},
  ()=>setTimeout(streamTick,300));  // retry after transient errors/429
}
// Binary WebSocket transport (serving/ws.py): ONE persistent socket, raw
// JPEG bytes both directions — no per-frame HTTP/base64/JSON, and up to 2
// frames in flight so upload, device compute and download overlap.
let ws=null,wsInflight=0;
const wsUrl=(location.protocol==='https:'?'wss://':'ws://')+location.host+'/stream';
function wsStop(){if(ws){const w=ws;ws=null;wsInflight=0;w.close();}}
function wsFrame(){
 if(!ws||ws.readyState!==1||!$('stream').checked||wsInflight>=2)return;
 const v=$('video');drawCrop(v,v.videoWidth,v.videoHeight)
  .toBlob(b=>{if(ws&&ws.readyState===1&&$('stream').checked){
   ws.send(b);wsInflight++;wsFrame();}},'image/jpeg',0.9);}
function wsStart(){
 ws=new WebSocket(wsUrl);ws.binaryType='arraybuffer';
 ws.onopen=()=>{ws.send(JSON.stringify({prompt:$('prompt').value,
  steps:+$('steps').value,use_cfg:$('cfg').checked,pipeline:true}));wsFrame();};
 ws.onmessage=ev=>{
  if(typeof ev.data==='string'){const j=JSON.parse(ev.data);
   if(j.status==='error'){$('status').textContent='ws error '+j.code+': '+(j.detail||'');
    // frame-level errors (429 busy etc.) consumed an in-flight slot:
    // release it and retry like streamTick, else the stream stalls at 2
    if(j.frame&&wsInflight>0){wsInflight--;setTimeout(wsFrame,300);}}
   return;}
  wsInflight--;
  const dv=new DataView(ev.data),n=dv.getUint32(0);
  const meta=JSON.parse(new TextDecoder().decode(new Uint8Array(ev.data,4,n)));
  const img=$('result'),old=img.dataset.bloburl;
  const url=URL.createObjectURL(new Blob([new Uint8Array(ev.data,4+n)],{type:'image/jpeg'}));
  img.src=url;img.dataset.bloburl=url;if(old)URL.revokeObjectURL(old);
  streamN++;const fps=streamN/((Date.now()-streamT0)/1000);
  $('status').textContent='ws streaming '+fps.toFixed(1)+' fps (frame '+streamN+
   (meta.keyframe?', keyframe':'')+')';
  wsFrame();};
 ws.onerror=()=>{if(ws){$('status').textContent='ws failed — falling back to HTTP';
  wsStop();streamTick();}};
 ws.onclose=()=>{if(ws){ws=null;wsInflight=0;}};}
// live prompt switch mid-stream: TEXT config frame re-freezes the prompt
// conditioning server-side, keeps the temporal latent
$('prompt').onchange=()=>{if(ws&&ws.readyState===1)
 ws.send(JSON.stringify({prompt:$('prompt').value}));};
$('stream').onchange=e=>{
 if(e.target.checked){streamSid='ui-'+Math.random().toString(36).slice(2);
  streamN=0;streamT0=Date.now();
  if($('wst').checked&&window.WebSocket)wsStart();else streamTick();}
 else{$('status').textContent='idle';wsStop();}};
</script></body></html>
"""


def create_ui(engine=None, preset: str = "qwen-image-edit-2509"):
    """Gradio Blocks UI (reference webui_realtime.py:185-316): a load
    button, then webcam, upload and composite tabs on ``engine`` (built
    from ``preset`` on the card by the load button when None). Requires
    gradio; raises ImportError with a pointer to /ui otherwise."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; use the built-in browser UI at /ui "
            "(serving.server) instead"
        ) from e

    import numpy as np

    from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

    state = {"engine": engine}

    def load_model():
        if state["engine"] is None:
            state["engine"] = InferenceEngine.create(preset)
        return "Model loaded ✓"

    def process(img: np.ndarray, prompt: str, steps: int):
        if state["engine"] is None:
            return None, "Load the model first"
        eng = state["engine"]
        # true-CFG convention of the Gradio path (webui_realtime.py:77-86)
        res = eng.pipeline(
            imaging.resize(imaging.as_uint8_array(img), eng.input_size, eng.input_size),
            prompt, negative_prompt=" ", true_cfg_scale=4.0,
            num_inference_steps=int(steps), seed=42,
        )
        return np.asarray(res.images[0]), f"{res.elapsed:.2f}s"

    def process_composite(a, b, ratio, prompt, steps):
        blended = imaging.blend(imaging.as_uint8_array(a), imaging.as_uint8_array(b),
                                float(ratio))
        return process(blended, prompt, steps)

    with gr.Blocks(title="Qwen-Image-Edit Realtime (GPU)") as demo:
        gr.Markdown("# Qwen-Image-Edit-2509 Realtime (GPU)")
        status = gr.Textbox(label="Status", value="model not loaded")
        gr.Button("Load Model").click(load_model, outputs=status)
        with gr.Tab("Webcam"):
            cam = gr.Image(sources=["webcam"], streaming=True)
            out = gr.Image(label="Edited")
            prompt = gr.Textbox(value="Transform into oil painting style",
                                label="Prompt")
            steps = gr.Slider(1, 8, value=4, step=1, label="Steps")
            t = gr.Textbox(label="Inference time")
            cam.change(process, [cam, prompt, steps], [out, t])
        with gr.Tab("Upload"):
            up = gr.Image(label="Input")
            out2 = gr.Image(label="Edited")
            prompt2 = gr.Textbox(value="Transform into oil painting style",
                                 label="Prompt")
            gr.Examples(  # example prompts (reference webui layout)
                examples=[
                    ["Transform into oil painting style"],
                    ["Make it look like a watercolor painting"],
                    ["Convert to anime style"],
                    ["Turn this into a cyberpunk scene with neon lights"],
                    ["Make it look like a pencil sketch"],
                ],
                inputs=[prompt2],
            )
            steps2 = gr.Slider(1, 8, value=4, step=1, label="Steps")
            t2 = gr.Textbox(label="Inference time")
            gr.Button("Edit").click(process, [up, prompt2, steps2], [out2, t2])
        with gr.Tab("Composite"):
            a = gr.Image(label="Image A")
            b = gr.Image(label="Image B")
            ratio = gr.Slider(0, 1, value=0.5, label="Blend ratio")
            out3 = gr.Image(label="Edited")
            prompt3 = gr.Textbox(value="Blend these scenes", label="Prompt")
            steps3 = gr.Slider(1, 8, value=4, step=1, label="Steps")
            t3 = gr.Textbox(label="Inference time")
            gr.Button("Composite").click(
                process_composite, [a, b, ratio, prompt3, steps3], [out3, t3]
            )
    return demo


def main():
    demo = create_ui()
    demo.launch(server_name="0.0.0.0", server_port=7865, share=False)


if __name__ == "__main__":
    main()
