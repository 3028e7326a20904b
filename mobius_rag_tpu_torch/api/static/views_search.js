/* Search-side tabs: direct query, agent (with decision narrative +
   per-hit signals), decisions browser with trace drilldown, and the
   search-trace (search_events) panel — arms/signals per event, the
   console form of the reference's SearchTracePanel. */
"use strict";

UI.tab("query", `
  <div class="row"><input id="q" placeholder="query text">
    <input id="qp" placeholder="payer filter" style="max-width:180px">
    <select id="qmode" style="max-width:130px">
      <option>corpus</option><option>precision</option><option>recall</option></select>
    <select id="qtm" style="max-width:130px">
      <option>strict</option><option>relaxed</option><option>none</option></select>
    <button class="go" onclick="doQuery()">search</button></div>
  <div id="qout"></div>`);

async function doQuery() {
  const body = { query: q.value, k: 10, mode: qmode.value, tag_mode: qtm.value };
  if (qp.value) body.payer = qp.value;
  const r = await UI.post("/api/query", body);
  qout.innerHTML = r.error ? UI.pre(r.error) :
    `<p>confidence: ${UI.lbl(r.confidence_label)}
     · expansion: <span class=meta>${UI.esc((r.expansion || []).join(", "))}</span>
     · strict_count ${r.telemetry?.strict_count ?? "?"}
     · prep ${(r.telemetry?.timings_ms?.prepare ?? 0).toFixed(2)} ms
     · device ${(r.telemetry?.timings_ms?.device ?? 0).toFixed(2)} ms/q</p>`
    + UI.hits(r.results);
}

UI.tab("agent", `
  <div class="row"><input id="aq" placeholder="ask the retrieval agent">
    <select id="amode" style="max-width:120px"><option value="">router</option>
      <option>a</option><option>b</option><option>c</option><option>d</option>
      <option>s</option><option value="a+b">a+b</option><option value="a+c">a+c</option></select>
    <select id="acm" style="max-width:170px"><option value="">caller mode</option>
      <option>chat_interactive</option><option>high_stakes</option>
      <option>bulk_eval</option><option>quick_lookup</option><option>research</option></select>
    <button class="go" onclick="doAgent()">run</button></div>
  <div id="aout"></div>`);

async function doAgent() {
  const body = { query: aq.value };
  if (amode.value) body.mode = amode.value;
  if (acm.value) body.caller_mode = acm.value;
  const r = await UI.post("/api/skills/v1/corpus_search_agent", body);
  if (r.error) { aout.innerHTML = UI.pre(r.error); return; }
  const scores = Object.entries(r.decision?.scores || {})
    .map(([s, v]) => `${s}:${v.toFixed(2)}`).join(" ");
  aout.innerHTML = `
    <p>chain: <b>${UI.esc((r.strategy_chain || []).join(" → "))}</b>
       · contour ${UI.esc(r.gate?.contour)} · class ${UI.esc(r.profile?.query_class)}
       · ${UI.lbl(r.confidence_label)} · scores <span class=meta>${UI.esc(scores)}</span></p>
    ${r.narrative ? `<div class=hit><b>narrative</b><div class=meta>${UI.esc(r.narrative)}</div></div>` : ""}
    ${UI.pre(r.answer || "(no answer)")}
    ${r.improvement_hint ? `<p class=meta>hint: ${UI.esc(r.improvement_hint)}</p>` : ""}
    ${UI.hits(r.chunks || [])}`;
}

UI.tab("decisions", `<div id="dstats" class=meta>…</div><div id="dout">…</div>`,
  loadDecisions);

async function loadDecisions() {
  // /routing/decisions carries the operator grade column; /routing/stats
  // the per-strategy rollup (reference routers/routing.py)
  const [r, st] = await Promise.all([
    UI.get("/routing/decisions?limit=50"),
    UI.get("/routing/stats").catch(() => null)]);
  if (st && st.strategies) {
    const parts = Object.entries(st.strategies).map(([s, x]) =>
      `${s}: n=${x.n} high=${x.confidence?.high ?? 0} ` +
      `refuse=${x.refusal_rate} ${x.latency_ms_mean}ms`);
    document.getElementById("dstats").textContent =
      `routing stats (${st.window_hours}h) — ` + parts.join(" · ");
  }
  dout.innerHTML = UI.table(
    ["query", "strategy", "chain", "class", "contour", "conf", "ms", "grade"],
    r.decisions.map((d) => `<tr class=click onclick="loadTrace(UI.d('${UI.arg(d.agent_id)}'))">
      <td>${UI.esc(d.query.slice(0, 60))}</td><td>${UI.esc(d.strategy)}</td>
      <td>${UI.esc(d.chain.join("→"))}</td><td>${UI.esc(d.query_class)}</td>
      <td>${UI.esc(d.contour)}</td><td>${UI.lbl(d.confidence)}</td>
      <td>${(d.latency_ms || 0).toFixed(0)}</td>
      <td onclick="event.stopPropagation()">
        ${d.grade ? UI.lbl(d.grade === "good" ? "high" : "low") + UI.esc(" " + d.grade)
          : `<button onclick="gradeDec(UI.d('${UI.arg(d.agent_id)}'),'good')">✓</button>
             <button onclick="gradeDec(UI.d('${UI.arg(d.agent_id)}'),'bad')">✗</button>`}
      </td></tr>`)) + "<div id=trace></div>";
}
async function gradeDec(id, grade) {
  // human decision-grading loop (PATCH /observe/decisions/{id}/grade)
  await UI.post(`/observe/decisions/${id}/grade`, { grade }, "PATCH");
  loadDecisions();
}
async function loadTrace(id) {
  const t = await UI.get(`/api/decisions/${id}/trace`);
  document.getElementById("trace").innerHTML =
    (t.narrative ? `<div class=hit><b>narrative</b><div class=meta>${UI.esc(t.narrative)}</div></div>` : "")
    + UI.pre(t);
}

UI.tab("trace", `
  <p class=meta>search_events — per-search timings, arm hits, scoring
  signals (the reference's search-trace panel)</p>
  <div id="evout">…</div>`, loadEvents);

async function loadEvents() {
  const r = await UI.get("/api/search_events?limit=40");
  window._events = r.events;
  evout.innerHTML = UI.table(
    ["ts", "query", "mode", "arms v/l/d", "results", "prep ms", "device ms"],
    r.events.map((e, i) => {
      const t = e.timings || {};
      const arms = e.arms || {};
      return `<tr class=click onclick="showEvent(${i})">
        <td class=meta>${new Date((e.ts || 0) * 1000).toISOString().slice(5, 19)}</td>
        <td>${UI.esc((e.query || "").slice(0, 48))}</td><td>${UI.esc(e.mode)}</td>
        <td>${arms.vector ?? "·"}/${arms.lexical ?? "·"}/${arms.dtag ?? "·"}</td>
        <td>${(e.results || []).length}</td>
        <td>${(t.prepare ?? 0).toFixed(2)}</td><td>${(t.device ?? 0).toFixed(2)}</td></tr>`;
    })) + "<div id=evdetail></div>";
}
function showEvent(i) {
  const e = window._events[i];
  const rows = (e.results || []).map((h) => {
    const s = h.signals || {};
    return `<tr><td>${UI.esc(h.chunk_id)}</td><td>${(h.score ?? 0).toFixed(3)}</td>
      <td>${(s.cosine ?? 0).toFixed(3)}</td><td>${(s.coverage ?? 0).toFixed(3)}</td>
      <td>${(s.jpd ?? 0).toFixed(3)}</td><td>${(s.authority ?? 0).toFixed(3)}</td>
      <td>${(s.rrf ?? 0).toFixed(4)}</td></tr>`;
  });
  document.getElementById("evdetail").innerHTML =
    `<div class=hit><b>${UI.esc(e.query)}</b>
      <div class=meta>expansion: ${UI.esc(JSON.stringify(e.expansion))}
        · extra: ${UI.esc(JSON.stringify(e.extra))}</div></div>` +
    UI.table(["chunk", "rerank", "cosine", "coverage", "jpd", "auth", "rrf"], rows);
}
