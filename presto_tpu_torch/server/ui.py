"""Single-file no-dependency Web UI (reference Web UI, server/ui/ +
webapp React app, reduced to self-contained pages polling the JSON
APIs the coordinator already serves).

Two pages:

- :func:`dashboard_html` — ``GET /ui``: cluster membership with
  drain/dead states (``/v1/cluster``), the query list with live
  progress bars (``/v1/query``), resource groups.
- :func:`query_page_html` — ``GET /ui/query/{id}``: one query's
  Stage -> Task -> Operator tree with the device-cost columns
  (flops / hbm_bytes / intensity / roofline, obs/devprof.py), the
  progress bar, and the trace / device-profile export links. The
  handler embeds the current snapshot server-side (the page re-polls
  ``/v1/query/{id}`` while the query runs).
"""

from __future__ import annotations

import json

_STYLE = """<style>
body{font-family:system-ui,sans-serif;margin:2em;background:#111;
color:#eee}
h1{font-size:1.3em} h2{font-size:1.05em;margin-top:1.4em}
a{color:#6cf;text-decoration:none} a:hover{text-decoration:underline}
table{border-collapse:collapse;width:100%;font-size:.85em}
td,th{border:1px solid #333;padding:.35em .6em;text-align:left}
th{background:#1c2733} .st-RUNNING{color:#6cf} .st-FINISHED{color:#6f6}
.st-FAILED{color:#f66} .st-QUEUED{color:#fc6} .st-CANCELED{color:#999}
.st-alive{color:#6f6} .st-draining,.st-drained{color:#fc6}
.st-dead{color:#f66} .st-joining{color:#6cf}
.serving{color:#6f6;font-size:.8em;margin-left:.6em}
.cards{display:flex;gap:1em} .card{background:#1c2733;padding:.8em
1.2em;border-radius:6px;min-width:7em}
.card b{font-size:1.6em;display:block}
.bar{background:#333;border-radius:3px;height:.8em;width:9em;
display:inline-block;vertical-align:middle}
.bar i{background:#36c;display:block;height:100%;border-radius:3px}
.pct{font-size:.8em;color:#9ab;margin-left:.4em}
.num{text-align:right;font-variant-numeric:tabular-nums}
</style>"""

_SHARED_JS = """
async function j(u){return (await fetch(u)).json()}
function esc(s){const d=document.createElement('span');
d.textContent=s==null?'':String(s);return d.innerHTML}
function bar(p){const pct=Math.round(100*Math.max(0,Math.min(1,p||0)));
return `<span class="bar"><i style="width:${pct}%"></i></span>`+
`<span class="pct">${pct}%</span>`}
"""

_DASHBOARD = """<!doctype html>
<html><head><title>presto-tpu</title>{style}</head><body>
<h1>presto-tpu coordinator</h1>
<div class="cards" id="cards"></div>
<h2>Workers</h2><table id="workers"><thead><tr><th>node</th>
<th>uri</th><th>state</th><th>schedulable</th><th>active tasks</th>
</tr></thead><tbody></tbody></table>
<h2>Queries</h2><table id="queries"><thead><tr><th>id</th><th>state
</th><th>progress</th><th>user</th><th>query</th></tr></thead>
<tbody></tbody></table>
<h2>Resource groups</h2><table id="groups"><thead><tr><th>group</th>
<th>policy</th><th>running</th><th>queued</th><th>limit</th>
</tr></thead><tbody></tbody></table>
<script>{shared_js}
function groupRows(gs,prefix){{let out='';for(const g of gs){{
out+=`<tr><td>${{esc(g.name)}}</td><td>${{esc(g.schedulingPolicy||'fair')}}
</td><td>${{g.running}}</td><td>${{g.queued}}</td>
<td>${{g.hardConcurrencyLimit}}</td></tr>`;
if(g.subGroups)out+=groupRows(g.subGroups)}}return out}}
function workerRows(ws){{if(!ws||!ws.length)
return '<tr><td colspan="5">local (no cluster configured)</td></tr>';
return ws.map(w=>{{
const st=w.alive?(w.state||'alive'):'dead';
return `<tr><td>${{esc(w.nodeId)}}</td><td>${{esc(w.uri)}}</td>
<td class="st-${{esc(st)}}">${{esc(st)}}</td>
<td>${{w.schedulable?'yes':'no'}}</td>
<td class="num">${{w.activeTasks==null?'':w.activeTasks}}</td></tr>`
}}).join('')}}
async function tick(){{
const c=await j('/v1/cluster');
document.getElementById('cards').innerHTML=
['runningQueries','queuedQueries','finishedQueries','failedQueries']
.map(k=>`<div class="card"><b>${{c[k]}}</b>${{k.replace('Queries','')}}
</div>`).join('');
document.querySelector('#workers tbody').innerHTML=
workerRows(c.workers);
const qs=await j('/v1/query');
document.querySelector('#queries tbody').innerHTML=qs.slice(-50)
.reverse().map(q=>`<tr>
<td><a href="/ui/query/${{esc(q.queryId)}}">${{esc(q.queryId)}}</a></td>
<td class="st-${{q.state}}">${{q.state}}</td>
<td>${{bar(q.progress)}}</td><td>${{esc(q.user)}}</td>
<td><code>${{esc((q.query||'').slice(0,120))}}</code></td></tr>`)
.join('');
const gs=await j('/v1/resourceGroup');
document.querySelector('#groups tbody').innerHTML=groupRows(gs);}}
tick();setInterval(tick,2000);
</script></body></html>"""

_QUERY_PAGE = """<!doctype html>
<html><head><title>presto-tpu query {qid}</title>{style}</head><body>
<h1>presto-tpu query <code>{qid}</code></h1>
<p><a href="/ui">&larr; dashboard</a> &middot;
<a href="/v1/query/{qid}/trace">chrome trace</a> &middot;
<a href="/v1/query/{qid}">raw JSON</a></p>
<div id="head"></div>
<div id="stages"></div>
<script>{shared_js}
const QID={qid_js};
let BOOT={boot_js};
const OPCOLS=['nodeType','label','inputRows','outputRows','estRows',
'wallMillis','flops','hbmBytes','intensity','roofline','kernel'];
function fmt(v){{if(typeof v==='number'&&!Number.isInteger(v))
return v.toFixed(3);return v==null||v===-1?'':v}}
function render(info){{
if(!info||!info.queryId)return;
const st=(info.stats&&info.stats.progress!=null)?info.stats.progress
:(info.queryStats||{{}}).progress;
const prof=(info.queryStats||{{}}).profile;
const mark=info.cacheHit?'result-cache hit'
:info.batched>1?`batched &times;${{info.batched}}`
:info.deduped?'deduped':'';
document.getElementById('head').innerHTML=
`<div class="cards">
<div class="card"><b class="st-${{info.state}}">${{info.state}}</b>
state${{mark?`<span class="serving">${{mark}}</span>`:''}}</div>
<div class="card"><b>${{bar(st)}}</b>progress</div>
<div class="card"><b>${{(info.stats||{{}}).elapsedTimeMillis||0}}</b>
elapsed ms</div>
<div class="card"><b>${{(info.stats||{{}}).processedRows||0}}</b>
rows</div></div>
<p><code>${{esc(info.query)}}</code></p>`+
(info.error?`<p class="st-FAILED">${{esc(info.error)}}</p>`:'')+
(prof?`<p>device profile: <code>${{esc(prof)}}</code></p>`:'');
const stats=info.queryStats;if(!stats)return;
let html='';
for(const stg of (stats.stages||[])){{
html+=`<h2>Stage ${{esc(stg.stage)}} &middot; `+
`${{stg.outputRows}} rows &middot; skew ${{stg.outputRowSkew}}</h2>`;
for(const t of (stg.tasks||[])){{
html+=`<h3 style="font-size:.95em">Task ${{esc(t.taskId)}} `+
`<span class="st-${{(t.state||'').toUpperCase()}}">${{esc(t.state)}}`+
`</span> &middot; node ${{esc(t.node)}} &middot; `+
`compiles ${{t.compiles}} &middot; cache hits ${{t.cacheHits}}</h3>`;
const ops=t.operators||[];
if(!ops.length)continue;
html+='<table><thead><tr>'+OPCOLS.map(c=>`<th>${{c}}</th>`).join('')+
'</tr></thead><tbody>'+ops.map(op=>'<tr>'+OPCOLS.map(c=>
`<td class="num">${{esc(fmt(op[c]))}}</td>`).join('')+'</tr>')
.join('')+'</tbody></table>'}}}}
document.getElementById('stages').innerHTML=html}}
render(BOOT);
async function tick(){{
try{{const info=await j('/v1/query/'+encodeURIComponent(QID));
render(info);
if(info&&(info.state==='FINISHED'||info.state==='FAILED'
||info.state==='CANCELED'))clearInterval(timer)}}catch(e){{}}}}
const timer=setInterval(tick,2000);
</script></body></html>"""


def _embed_json(obj) -> str:
    """JSON safe to inline inside a <script> block (no '</script>'
    early-termination, no U+2028/U+2029 JS syntax errors)."""
    return (json.dumps(obj).replace("</", "<\\/")
            .replace("\u2028", "\\u2028").replace("\u2029", "\\u2029"))


def dashboard_html() -> str:
    return _DASHBOARD.format(style=_STYLE, shared_js=_SHARED_JS)


def query_page_html(query_id: str, info: dict | None) -> str:
    """Per-query observatory page. ``info`` is the /v1/query/{id}
    response dict (embedded server-side so the page renders without a
    fetch), or None for unknown/not-viewable queries."""
    safe_qid = "".join(c for c in str(query_id)
                       if c.isalnum() or c in "-_.")[:128]
    return _QUERY_PAGE.format(
        style=_STYLE, shared_js=_SHARED_JS, qid=safe_qid,
        qid_js=_embed_json(safe_qid),
        boot_js=_embed_json(info) if info is not None else "null")
